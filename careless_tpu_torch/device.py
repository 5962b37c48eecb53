"""Device selection for the port's entry points.

`device=None` means the card. Without one the entry point raises: the port
never carries on quietly on the CPU. Callers that want the CPU (the tests)
say so with `device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def same_device(a, b) -> bool:
    """Whether two device specs name one device (an unindexed CUDA device
    is the current one)."""
    a, b = torch.device(a), torch.device(b)

    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


def seeded_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A torch.Generator on `device`, seeded explicitly."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
