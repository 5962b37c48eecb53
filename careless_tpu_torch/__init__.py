"""PyTorch / CUDA port of careless-tpu for NVIDIA Hopper (H100).

The JAX package `careless_tpu` is the reference; this package computes the
same merge with PyTorch tensors, and every TPU kernel on the ported path is a
hand-written CUDA kernel under `csrc/` (built at first use, see
`kernels/_build.py`). Entry points run on the card unless the caller passes
`device="cpu"`; on the CPU each kernel wrapper runs its plain PyTorch
version.
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
