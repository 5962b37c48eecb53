"""Philox4x32-10 standard normals in int64 tensor arithmetic.

A frozen copy of the port's plain version of its noise kernel: element i of
a call under the 64-bit key `key` at offset o is a function of (key, o + i)
alone. Index e lies in Philox block e >> 2 at slot e & 3; the block's four
words give two pairs of uniforms on (0, 1], u = ((r >> 8) + 1) 2^-24, and
each pair two Box-Muller normals (slot 0: sqrt(-2 log u(r0)) cos(2 pi
u(r1)), slot 1 the same with sin, slots 2 and 3 the same of (r2, r3)).
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of m * x for uint32 m and x held in int64."""
    t1 = m * (x & 0xFFFF)
    t2 = m * (x >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _M32


def philox4x32_10(counter: torch.Tensor, key: int):
    c0 = counter & _M32
    c1 = (counter >> 32) & _M32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = key & _M32, (key >> 32) & _M32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(word: torch.Tensor) -> torch.Tensor:
    return ((word >> 8) + 1).to(torch.float32) * 2.0 ** -24


def normals(n: int, key: int, offset: int, device,
            block: int = 1 << 22) -> torch.Tensor:
    """(n,) normals of indices offset .. offset + n - 1 under `key`, made
    `block` elements at a time."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, block):
        e = offset + lo + torch.arange(min(block, n - lo), dtype=torch.int64,
                                       device=device)
        r0, r1, r2, r3 = philox4x32_10(e >> 2, int(key))
        slot = e & 3
        high = slot >= 2
        ra, rb = torch.where(high, r2, r0), torch.where(high, r3, r1)
        angle = TWO_PI_F32 * _uniform(rb)
        trig = torch.where((slot & 1) == 1, torch.sin(angle),
                           torch.cos(angle))
        out[lo:lo + len(e)] = torch.sqrt(-2.0 * torch.log(_uniform(ra))) * trig
    return out
