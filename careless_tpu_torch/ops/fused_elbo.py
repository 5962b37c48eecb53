"""Standard normals from Philox4x32-10: kernel K3 and its plain version.

Counterpart of careless_tpu/ops/fused_elbo.py:prng_normal (the TPU's
in-kernel PRNG through prng_normal_probe). The fused likelihood kernel of
that module (K4) is not ported yet.

The stream is counter-based: element i of a call with 64-bit key `seed`
and `offset` o is a function of (seed, o + i) alone, so calls with one key
and disjoint counter ranges never share a number, and any range can be
regenerated. Of Philox's four output words, r0 and r1 give two uniforms on
(0, 1], u = ((r >> 8) + 1) * 2^-24, and one Box-Muller normal
sqrt(-2 log u1) cos(2 pi u2). The plain version implements the same Philox
bit for bit in int64 arithmetic, so the card can compare the kernel's raw
words exactly and its normals to a few ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_TWO_M24 = 2.0 ** -24


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for uint32 m and x held in int64,
    without overflowing int64 (x is split into 16-bit halves)."""
    t1 = m * (x & 0xFFFF)
    t2 = m * (x >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _M32


def philox4x32_10(counter: torch.Tensor, seed: int):
    """Philox4x32-10 on 64-bit counters (int64 tensor, words 2 and 3 zero)
    under the 64-bit key `seed`; returns the four output words as int64
    tensors holding uint32 values."""
    c0 = counter & _M32
    c1 = (counter >> 32) & _M32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(word: torch.Tensor) -> torch.Tensor:
    return ((word >> 8) + 1).to(torch.float32) * _TWO_M24


def plain_prng_normal(n: int, seed: int, offset: int, device,
                      with_bits: bool = False):
    """The plain PyTorch version of K3 (same words, same arithmetic)."""
    counter = offset + torch.arange(n, dtype=torch.int64, device=device)
    r0, r1, _, _ = philox4x32_10(counter, int(seed))
    u1, u2 = _uniform(r0), _uniform(r1)
    out = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)
    if not with_bits:
        return out
    bits = torch.stack([r0, r1], dim=1)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return out, bits


def prng_normal(n: int, seed: int, offset: int, device) -> torch.Tensor:
    """(n,) standard normals for counters offset .. offset + n - 1 under the
    64-bit key `seed`. On the CPU this is the plain version; on the card K3
    (csrc/philox.cu)."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain_prng_normal(n, seed, offset, device)
    return kernels.philox_normal(n, int(seed), int(offset), device)
