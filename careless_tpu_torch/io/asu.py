"""Reciprocal asymmetric-unit bookkeeping.

The port's own copy of careless_tpu/io/asu.py without pandas. A
ReciprocalASU enumerates the unique Miller indices in the reciprocal ASU to
dmin (optionally Friedel-separated) with per-reflection centric flags,
multiplicity epsilon and d-spacing; a collection concatenates several ASUs
into one contiguous global refl_id space (offset per ASU) with maps both
ways between (asu_id, H) and refl_id. Miller-index lookups search sorted
packed keys (`pack_hkl`) where the JAX package indexes a pandas MultiIndex.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..xtal import SpaceGroup, UnitCell

_HKL_BITS = 21
_HKL_OFFSET = 1 << (_HKL_BITS - 1)


def pack_hkl(H: np.ndarray) -> np.ndarray:
    """(n,) int64 keys of (n, 3) Miller indices, ordered as the indices
    are lexicographically (|h|, |k|, |l| < 2^20)."""
    H = np.atleast_2d(np.asarray(H, dtype=np.int64))
    if H.size and np.abs(H).max() >= _HKL_OFFSET:
        raise ValueError("Miller indices past +-2^20 cannot be packed")
    h, k, l = (H + _HKL_OFFSET).T
    return (h << (2 * _HKL_BITS)) | (k << _HKL_BITS) | l


class ReciprocalASU:
    def __init__(self, cell: UnitCell, spacegroup: SpaceGroup, dmin: float,
                 anomalous: bool):
        self.cell = cell
        self.spacegroup = spacegroup
        self.dmin = float(dmin)
        self.anomalous = anomalous
        self.Hall = spacegroup.generate_reciprocal_asu(cell, dmin, anomalous)
        self.centric = spacegroup.is_centric(self.Hall)
        self.multiplicity = spacegroup.epsilon(self.Hall).astype(np.float32)
        self.dHKL = cell.compute_d(self.Hall).astype(np.float32)
        keys = pack_hkl(self.Hall)
        self._order = np.argsort(keys, kind="stable")
        self._keys = keys[self._order]

    def __len__(self) -> int:
        return len(self.Hall)

    def to_refl_id(self, H: np.ndarray) -> np.ndarray:
        """Map (n, 3) ASU Miller indices to integer reflection ids
        (float array with NaN marking indices not in this ASU)."""
        keys = pack_hkl(H)
        if not len(self._keys):
            return np.full(len(keys), np.nan)
        pos = np.minimum(np.searchsorted(self._keys, keys),
                         len(self._keys) - 1)
        return np.where(self._keys[pos] == keys, self._order[pos], np.nan)

    def to_miller_index(self, refl_id: np.ndarray) -> np.ndarray:
        return self.Hall[np.asarray(refl_id, dtype=np.int64)]


class ReciprocalASUCollection:
    def __init__(self, reciprocal_asus: Sequence[ReciprocalASU]):
        self.reciprocal_asus: List[ReciprocalASU] = list(reciprocal_asus)
        sizes = [len(a) for a in self.reciprocal_asus]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        self.asu_ids = np.concatenate([
            np.full(len(a), i, dtype=np.int64)
            for i, a in enumerate(self.reciprocal_asus)])
        self.hkls = np.concatenate([a.Hall for a in self.reciprocal_asus])
        self.centric = np.concatenate([a.centric for a in self.reciprocal_asus])
        self.multiplicity = np.concatenate(
            [a.multiplicity for a in self.reciprocal_asus])
        self.dHKL = np.concatenate([a.dHKL for a in self.reciprocal_asus])

    def __len__(self) -> int:
        """Number of ASUs."""
        return len(self.reciprocal_asus)

    @property
    def n_refl(self) -> int:
        """Total reflections across the global contiguous refl_id space."""
        return len(self.hkls)

    def __iter__(self):
        return iter(self.reciprocal_asus)

    def __getitem__(self, i) -> ReciprocalASU:
        return self.reciprocal_asus[i]

    def to_refl_id(self, asu_id: np.ndarray, H: np.ndarray,
                   allow_missing: bool = False) -> np.ndarray:
        """Global refl ids for (asu_id, H) pairs; missing -> -1 if allowed."""
        asu_id = np.asarray(asu_id, dtype=np.int64).reshape(-1)
        H = np.atleast_2d(np.asarray(H, dtype=np.int64))
        out = np.full(len(asu_id), -1, dtype=np.int64)
        for i, asu in enumerate(self.reciprocal_asus):
            mask = asu_id == i
            if not mask.any():
                continue
            local = asu.to_refl_id(H[mask])  # float w/ NaN for missing
            good = ~np.isnan(local)
            vals = np.where(good, np.nan_to_num(local, nan=-1.0), -1.0)
            vals = vals.astype(np.int64)
            vals = np.where(vals >= 0, vals + self.offsets[i], -1)
            out[mask] = vals
        if not allow_missing and (out < 0).any():
            raise KeyError("Miller indices not found in ASU collection")
        return out

    def to_asu_id_and_miller_index(self, refl_id: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        refl_id = np.asarray(refl_id, dtype=np.int64).reshape(-1)
        return self.asu_ids[refl_id], self.hkls[refl_id]
