"""Optimizer flags (same surface as reference careless/args/optimizer.py)."""
name = "Optimizer Parameters"
description = None

args_and_kwargs = (
    (("--iterations",), {
        "help": "Total number of full-batch Adam steps (default 10000).",
        "type": int,
        "default": 10000,
    }),
    (("--learning-rate",), {
        "help": "Adam step size (default 0.001).",
        "type": float,
        "default": 0.001,
    }),
    (("--beta-1",), {
        "help": "Adam first-moment decay rate (default 0.9).",
        "type": float,
        "default": 0.9,
    }),
    (("--beta-2",), {
        "help": "Adam second-moment decay rate (default 0.99).",
        "type": float,
        "default": 0.99,
    }),
    (("--clipnorm",), {
        "help": "Rescale each parameter tensor's gradient so its norm never "
                "exceeds this bound.",
        "type": float,
        "default": None,
    }),
    (("--clipvalue",), {
        "help": "Clamp every gradient element into [-value, value].",
        "type": float,
        "default": None,
    }),
    (("--global-clipnorm",), {
        "help": "Rescale the concatenated gradient so the global norm never "
                "exceeds this bound.",
        "type": float,
        "default": None,
    }),
    (("--steps-per-compile",), {
        "help": "How many optimization steps run between two reads of "
                "the metrics by the host (one synchronisation per chunk). "
                "The default is 100.",
        "type": int,
        "default": 100,
    }),
)
