"""Laue-specific flags (same surface as reference careless/args/poly.py)."""
name = "Laue"
description = None

args_and_kwargs = (
    (("-l", "--wavelength-range"), {
        "help": "Bandpass limits (Ångstroms) used when expanding each "
                "observation into its harmonic candidates. When omitted, "
                "the limits are taken from the wavelengths present in the "
                "input file.",
        "type": float,
        "default": None,
        "nargs": 2,
        "metavar": ("lambda_min", "lambda_max"),
    }),
    (("-w", "--wavelength-key"), {
        "help": "Which MTZ column holds each reflection's assigned peak "
                "wavelength. The default is 'Wavelength'.",
        "type": str,
        "default": "Wavelength",
    }),
)
