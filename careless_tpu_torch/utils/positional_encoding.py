"""NeRF-style positional encoding of metadata columns.

The port's own copy of careless_tpu/utils/positional_encoding.py. Columns
are min-max normalized to [-1, 1], then expanded with (cos(pi 2^l p),
sin(pi 2^l p)) for l = 0..L-1. Host-side numpy (runs once).
"""
from __future__ import annotations

import numpy as np


def positional_encoding(X: np.ndarray, L: int) -> np.ndarray:
    X = np.asarray(X, dtype=np.float32)
    denom = X.max(-2) - X.min(-2)
    denom = np.where(denom == 0, 1.0, denom)
    p = 2.0 * (X - X.min(-2)) / denom - 1.0
    freqs = np.pi * 2.0 ** np.arange(L, dtype=X.dtype)
    fp = (freqs[..., None, :] * p[..., :, None]).reshape(p.shape[:-1] + (-1,))
    return np.concatenate((np.cos(fp), np.sin(fp)), axis=-1)
