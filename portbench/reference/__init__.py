"""The plain reference of the benchmark's merge step: plain PyTorch and
numpy, imports nothing of the port or of the JAX package, and takes
nothing the port made. It works the port's derived state out again from the
problem arrays and the seed: the row layout (layout.py), the scale noise
(philox.py) and the initial parameters (merge.py)."""

import importlib


def load(name: str):
    """The reference module a configuration names (its `reference` key)."""
    return importlib.import_module(f"{__name__}.{name}")
