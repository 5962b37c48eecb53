"""Launchers for the port's CUDA kernels (csrc/), with their launch counts.

Each launcher takes CUDA tensors only, checks device, type, shape and
contiguity, allocates its outputs with torch.empty, launches on PyTorch's
current stream and raises if the launch was refused. `LAUNCHES[name]` grows
by one for every call that launches its kernel; nothing else touches it.
The ops modules decide between these launchers and the plain versions by
the device of the tensors they are given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library

LAUNCHES = {"trunk_fwd": 0, "trunk_bwd": 0, "gather": 0, "philox_normal": 0}

# widths with an instantiated trunk kernel (csrc/trunk.cu CT_TRUNK_WIDTHS)
TRUNK_WIDTHS = tuple(range(1, 17)) + (20, 24, 28, 32)
MAX_SMEM_PER_BLOCK = 232448    # H100: 227 KB of dynamic shared memory
SMEM_PER_SM = 233472           # H100: 228 KB per SM, 1 KB reserved per block


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def trunk_width(width: int) -> int:
    """The instantiated kernel width a trunk of `width` runs at (the
    wrapper zero-pads the weights up to it, which is exact)."""
    for w in TRUNK_WIDTHS:
        if w >= width:
            return w
    raise ValueError(f"MLP width {width} exceeds the trunk kernel's cap of "
                     f"{TRUNK_WIDTHS[-1]}")


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = library().ct_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             device: torch.device) -> None:
    if (device.type != "cuda" or t.device != device or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}; got {t.dtype} on {t.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _trunk_smem(d_in: int, width: int, n_layers: int, backward: bool) -> int:
    smem = library().ct_trunk_smem(d_in, width, n_layers, int(backward))
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(
            f"trunk of {n_layers} layers at width {width} (d_in {d_in}) "
            f"needs {smem} bytes of shared memory "
            f"({'backward' if backward else 'forward'}); the card allows "
            f"{MAX_SMEM_PER_BLOCK}")
    return smem


def trunk_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              width: int, n_layers: int, leak: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-fwd: flat (N,) loc and raw from metadata x (N, d_in) and the flat
    packed weights/biases of csrc/trunk.cu at an instantiated width."""
    dev = x.device
    _require(x, "x", torch.float32, dev)
    _require(w, "w", torch.float32, dev)
    _require(b, "b", torch.float32, dev)
    n, d_in = x.shape
    _trunk_smem(d_in, width, n_layers, False)
    loc = torch.empty(n, dtype=torch.float32, device=dev)
    raw = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().ct_trunk_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), loc.data_ptr(),
            raw.data_ptr(), n, d_in, width, n_layers, leak, _stream(dev))
    _check(err, "trunk forward")
    LAUNCHES["trunk_fwd"] += 1
    return loc, raw


def _trunk_bwd_blocks(n: int, d_in: int, width: int, n_layers: int,
                     device: torch.device) -> int:
    """The backward's fixed grid: as many blocks as fit on the card at once,
    never more than there are tiles. Fixed for a given shape and card, so
    the reduction order, and with it dW, is repeatable bit for bit."""
    smem = _trunk_smem(d_in, width, n_layers, True)
    per_sm = max(1, SMEM_PER_SM // (smem + 1024))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-n // 64)
    return max(1, min(tiles, per_sm * sms))


def trunk_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dloc: torch.Tensor, draw: torch.Tensor, width: int,
              n_layers: int, leak: float, need_dx: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1-bwd: (dw, db, dx) for the flat packed weights/biases; dx only
    when asked for (metadata takes no gradient on the training path)."""
    dev = x.device
    for t, name in ((x, "x"), (w, "w"), (b, "b"), (dloc, "dloc"),
                    (draw, "draw")):
        _require(t, name, torch.float32, dev)
    n, d_in = x.shape
    n_blocks = _trunk_bwd_blocks(n, d_in, width, n_layers, dev)
    nw, nb = w.numel(), b.numel()
    part = torch.empty((n_blocks, nw + nb), dtype=torch.float32, device=dev)
    out = torch.empty(nw + nb, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    with torch.cuda.device(dev):
        err = library().ct_trunk_bwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dloc.data_ptr(),
            draw.data_ptr(), None if dx is None else dx.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, d_in, width, n_layers,
            n_blocks, leak, _stream(dev))
    _check(err, "trunk backward")
    LAUNCHES["trunk_bwd"] += 1
    return out[:nw], out[nw:], dx


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K2: table[ids] for a flat f32 table and int32 ids whose range the
    caller has validated (make_gather_plan does, once, on the host)."""
    dev = table.device
    _require(table, "table", torch.float32, dev)
    _require(ids, "ids", torch.int32, dev)
    if ids.data_ptr() % 16:
        ids = ids.clone()  # the kernel loads ids 16 bytes at a time
    out = torch.empty(ids.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().ct_gather(table.data_ptr(), ids.data_ptr(),
                                  out.data_ptr(), ids.numel(), _stream(dev))
    _check(err, "gather")
    LAUNCHES["gather"] += 1
    return out


def philox_normal(n: int, seed: int, offset: int, device: torch.device,
                  with_bits: bool = False):
    """K3: (n,) standard normals for counters offset .. offset + n - 1 under
    the 64-bit key `seed`; with_bits also returns the (n, 2) raw words
    (r0, r1) as int32 for bitwise comparison with the plain version."""
    if device.type != "cuda":
        raise ValueError(f"the Philox kernel runs on a CUDA device, not {device}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    bits = (torch.empty((n, 2), dtype=torch.int32, device=device)
            if with_bits else None)
    with torch.cuda.device(device):
        err = library().ct_philox_normal(
            out.data_ptr(), None if bits is None else bits.data_ptr(), n,
            seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, offset,
            _stream(device))
    _check(err, "philox normal")
    LAUNCHES["philox_normal"] += 1
    return (out, bits) if with_bits else out
