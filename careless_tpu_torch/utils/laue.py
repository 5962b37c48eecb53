"""Harmonic expansion for polychromatic (Laue) data.

Counterpart of careless_tpu/utils/laue.py on the port's numpy DataSet. Each
observed reflection lies on a central ray; it is expanded to every harmonic
h = n * H_0 of that ray within the resolution cutoff, with wavelength
lambda_0 / n. d_0 and lambda_0 are computed in float64 and the expanded
wavelength is stored in float32, so the columns equal the JAX package's bit
for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..xtal import DataSet


def calculate_harmonic(H: np.ndarray) -> np.ndarray:
    """The harmonic index n = gcd(|h|, |k|, |l|) of each Miller index."""
    return np.gcd.reduce(np.abs(np.asarray(H, dtype=np.int64)), axis=-1)


def expand_harmonics(ds: DataSet, dmin: Optional[float] = None,
                     wavelength_key: str = "Wavelength") -> DataSet:
    """A copy of `ds` with each row repeated once per harmonic out to dmin
    (rows of one observation adjacent, n ascending). Adds H_0, K_0, L_0,
    the innermost reflection of each row's central ray, and sets H, K, L,
    the wavelength and dHKL to the harmonic's."""
    ds = ds.copy()
    if "dHKL" not in ds:
        ds.compute_dHKL(inplace=True)
    if dmin is None:
        dmin = float(ds["dHKL"].min()) - 1e-12

    Hobs = ds.get_hkls()
    nobs = np.maximum(calculate_harmonic(Hobs), 1)

    H_0 = (Hobs / nobs[:, None]).astype(np.int32)
    d_0 = ds["dHKL"].astype(np.float64) * nobs
    wav_0 = ds[wavelength_key].astype(np.float64) * nobs

    n_max = np.floor_divide(d_0, dmin).astype(np.int64)
    n_range = np.arange(max(1, n_max.max())) + 1
    idx, n = np.where(n_range[None, :] <= n_max[:, None])
    n = n + 1

    out = ds.select(idx)
    out["H_0"], out["K_0"], out["L_0"] = H_0[idx].T
    out[wavelength_key] = (wav_0[idx] / n).astype(np.float32)
    hkl_n = (n[:, None] * H_0[idx]).astype(np.int64)
    out["H"], out["K"], out["L"] = hkl_n.T
    out.compute_dHKL(inplace=True)
    return out
