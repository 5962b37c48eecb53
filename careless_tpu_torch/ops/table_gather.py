"""Table gathers, out[k] = table[ids[k]]: kernels K2 and K5 and their plain
versions.

Counterpart of careless_tpu/ops/table_gather.py.

K2 (windowed_gather there): the TPU kernel's window/bases plan was a VMEM
device and is not part of the contract; the CUDA kernel (csrc/gather.cu)
takes the flat ids directly. The caller validates the ids once, when it
builds them (the plans of ops/plan_gather.py: int32, contiguous, aligned,
inside the table), so a launch checks only type, device and contiguity.

K5 (windowed_gather_stream there): the same gather for tables past the
TPU's VMEM cap, with the TPU kernel's windowed contract kept. ids come as
(R, 128) tiles, `block_rows` rows of 128 to a tile, and tile i resolves
only ids inside its window, table rows [bases[i], bases[i] + window) of
128 entries; an id outside it gives 0. The table reads as if zero-padded
past its end. The CUDA kernel (csrc/gather_stream.cu) stages each tile's
window in shared memory with one bulk asynchronous copy, loads the tile's
ids while it runs, and resolves them from there.
"""
from __future__ import annotations

import torch

from .. import kernels

LANES = 128      # entries in a row of a windowed gather's tiles and table
BLOCK_ROWS = 64  # rows in a tile: 64 x 128 = 8192 observations


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


def _check_tiles(ids2d: torch.Tensor, bases: torch.Tensor, window: int,
                 block_rows: int) -> None:
    if (ids2d.dim() != 2 or ids2d.shape[1] != LANES or bases.dim() != 1
            or ids2d.shape[0] != bases.shape[0] * block_rows or window < 1):
        raise ValueError(
            f"windowed gather wants ids2d ({bases.shape[0] * block_rows}, "
            f"{LANES}) for {tuple(bases.shape)} bases of {block_rows}-row "
            f"tiles and window >= 1; got ids2d {tuple(ids2d.shape)}, "
            f"window {window}")


def plain_windowed_gather(table: torch.Tensor, ids2d: torch.Tensor,
                          bases: torch.Tensor, window: int,
                          block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The plain PyTorch version of K5: (R * 128,) values."""
    t = table.shape[0]
    ids = ids2d.reshape(bases.shape[0], block_rows * LANES).long()
    off = ids - LANES * bases.long()[:, None]
    inside = (off >= 0) & (off < window * LANES)
    rows = max(-(-t // LANES), window,
               int(bases.max()) + window if bases.numel() else 0)
    padded = torch.cat([table, table.new_zeros(rows * LANES - t)])
    vals = padded[torch.where(inside, ids, 0)]
    return torch.where(inside, vals, torch.zeros_like(vals)).reshape(-1)


def windowed_gather_stream(table: torch.Tensor, ids2d: torch.Tensor,
                           bases: torch.Tensor, window: int,
                           block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """K5's contract (the module docstring) for a flat f32 table, int32
    (R, 128) id tiles and int32 per-tile bases; returns (R * 128,) values.

    On CPU tensors this runs the plain version; on CUDA tensors it launches
    K5 (csrc/gather_stream.cu) and raises if it cannot. The tile shapes
    are checked here, for both."""
    _check_tiles(ids2d, bases, window, block_rows)
    if table.device.type == "cpu":
        return plain_windowed_gather(table, ids2d, bases, window, block_rows)
    return kernels.gather_stream(table.contiguous(), ids2d.contiguous(),
                                 bases.contiguous(), window, block_rows)
