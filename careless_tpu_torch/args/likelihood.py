"""Likelihood flags (same surface as reference careless/args/likelihood.py)."""
name = "Likelihood Options"
description = None

args_and_kwargs = (
    (("--studentt-likelihood-dof",), {
        "help": "Score observed intensities with a Student's t likelihood "
                "using this many degrees of freedom instead of the default "
                "normal likelihood. Robust against outlier observations.",
        "type": float,
        "metavar": "DOF",
        "default": None,
    }),
    (("--refine-uncertainties",), {
        "help": "Learn per-run corrections to the reported sigmas with the "
                "SDFAC/SDB/SDADD error model of Evans 2011 (as in SCALA/"
                "aimless).",
        "action": "store_true",
        "default": False,
    }),
)
