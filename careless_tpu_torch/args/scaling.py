"""Scaling model flags (same surface as reference careless/args/scaling.py)."""
name = "Scaling Model"
description = """
Controls for the neural scaling model that maps per-observation metadata to
scale-factor distributions.
"""

args_and_kwargs = (
    (("--scale-file",), {
        "help": "Warm-start the scaling model from a *_scale.npz file "
                "written by an earlier run.",
        "type": str,
        "default": None,
    }),
    (("--freeze-scales",), {
        "help": "Keep the scaling model fixed at its initial (or loaded) "
                "weights; only the structure factors are trained.",
        "action": "store_true",
    }),
    (("--mlp-layers",), {
        "help": "Depth of the scaling MLP in dense layers (default 20).",
        "type": int,
        "default": 20,
    }),
    (("--mlp-width",), {
        "help": "Hidden width of the scaling MLP. When omitted, the width "
                "matches the number of metadata columns.",
        "type": int,
        "default": None,
    }),
    (("--image-layers",), {
        "help": "Insert this many image-conditioned layers (each image gets "
                "its own weights) ahead of the shared MLP. 0 disables them.",
        "type": int,
        "default": 0,
    }),
    (("--disable-image-scales",), {
        "help": "Turn off the per-image scalar multiplier that is otherwise "
                "learned alongside the MLP.",
        "action": "store_false",
        "dest": "use_image_scales",
        "default": True,
    }),
    (("--scale-bijector",), {
        "help": "Positivity transform applied to the standard deviation "
                "output of the scaling model: 'exp' or 'softplus'.",
        "type": str,
        "default": "exp",
        "choices": ["exp", "softplus"],
    }),
)
