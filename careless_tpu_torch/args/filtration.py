"""Data filtration flags (same surface as reference careless/args/filtration.py)."""
name = "Data Filtration"
description = None

args_and_kwargs = (
    (("-c", "--isigi-cutoff"), {
        "help": "Drop observations whose I/sigma(I) falls below this value "
                "before merging. When omitted, nothing is filtered on "
                "signal-to-noise.",
        "type": float,
        "default": None,
    }),
    (("-d", "--dmin"), {
        "help": "High-resolution cutoff in Ångstroms: reflections beyond "
                "this d-spacing are discarded. When omitted, everything in "
                "the input is kept out to its highest-resolution observation.",
        "type": float,
        "default": None,
    }),
)
