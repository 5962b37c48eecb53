"""Table gather, out[k] = table[ids[k]]: kernel K2 and its plain version.

Counterpart of careless_tpu/ops/table_gather.py (windowed_gather). The TPU
kernel's window/bases plan was a VMEM device and is not part of the
contract; the CUDA kernel (csrc/gather.cu) takes the flat ids directly.
The caller validates the id range once, on the host (ops/plan_gather.py).
"""
from __future__ import annotations

import torch

from .. import kernels


def plain_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2."""
    return table[ids.long()]


def table_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a flat f32 table and int32 ids of any shape.

    On CPU tensors this runs the plain version; on CUDA tensors it launches
    K2 (csrc/gather.cu) and raises if it cannot."""
    if table.device.type == "cpu":
        return plain_gather(table, ids)
    return kernels.gather(table.contiguous(), ids.contiguous())
