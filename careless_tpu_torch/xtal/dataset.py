"""DataSet: an ordered table of numpy columns with crystallographic context.

Counterpart of careless_tpu/xtal/dataset.py, whose DataSet is a pandas
DataFrame; the port needs no pandas. A DataSet holds equal-length numpy
columns in insertion order, a unit cell, a space group and per-column MTZ
type tags, and offers what the formatter, the manager and mtz.py call:
column get and set (a scalar broadcasts), row selection by mask or index
(rows keep their order, as pandas' drop and reset_index do),
compute_dHKL, remove_absences, hkl_to_asu, label_centrics,
compute_multiplicity, get_hkls / set_hkls and concat_datasets.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from .cell import UnitCell
from .symmetry import SpaceGroup

# Default MTZ column type per canonical column name
DEFAULT_MTZ_TYPES = {
    "H": "H", "K": "H", "L": "H",
    "BATCH": "B",
    "I": "J", "SIGI": "Q", "SigI": "Q",
    "F": "F", "SIGF": "Q", "SigF": "Q",
    "M/ISYM": "Y",
}


class DataSet:
    """Columns (name -> (n,) array) + (cell, spacegroup, mtz_dtypes)."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 cell: Optional[UnitCell] = None,
                 spacegroup: Optional[SpaceGroup] = None,
                 mtz_dtypes: Optional[Dict[str, str]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        self._n: Optional[int] = None
        for k, v in (columns or {}).items():
            self[k] = v
        self.cell = cell
        self.spacegroup = spacegroup
        self.mtz_dtypes = dict(mtz_dtypes or {})

    # --------------------------------------------------------------- table
    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n or 0

    def __contains__(self, key) -> bool:
        return key in self._cols

    def __getitem__(self, key: str) -> np.ndarray:
        return self._cols[key]

    def __setitem__(self, key: str, value) -> None:
        arr = np.asarray(value)
        if arr.ndim == 0:
            if self._n is None:
                raise ValueError("cannot broadcast a scalar into an empty "
                                 "DataSet")
            arr = np.full(self._n, arr[()])
        if arr.ndim != 1:
            raise ValueError(f"column {key!r} must be 1-D, got {arr.shape}")
        if self._n is not None and len(arr) != self._n:
            raise ValueError(f"column {key!r} has {len(arr)} rows; the "
                             f"DataSet has {self._n}")
        self._n = len(arr)
        self._cols[key] = arr

    def to_numpy(self, keys: Sequence[str], dtype=None) -> np.ndarray:
        """(n, len(keys)) array of the named columns. It is Fortran-ordered,
        as pandas' to_numpy gives, so that numpy's reductions over rows
        sum in pandas' order."""
        dtype = dtype or np.result_type(*(self._cols[k] for k in keys))
        out = np.empty((len(self), len(keys)), dtype=dtype, order="F")
        for j, k in enumerate(keys):
            out[:, j] = self._cols[k]
        return out

    def _like(self, cols: Dict[str, np.ndarray]) -> "DataSet":
        return DataSet(cols, cell=self.cell, spacegroup=self.spacegroup,
                       mtz_dtypes=self.mtz_dtypes)

    def select(self, rows) -> "DataSet":
        """The rows picked by a boolean mask or an index array, in order."""
        return self._like({k: v[rows] for k, v in self._cols.items()})

    def drop_rows(self, mask: np.ndarray) -> None:
        """Remove the rows where mask is True, keeping the others' order."""
        mask = np.asarray(mask, bool)
        if mask.any():
            keep = ~mask
            self._cols = {k: v[keep] for k, v in self._cols.items()}
            self._n = int(keep.sum())

    def copy(self) -> "DataSet":
        return self._like({k: v.copy() for k, v in self._cols.items()})

    # ------------------------------------------------------------ helpers
    def get_hkls(self) -> np.ndarray:
        return self.to_numpy(["H", "K", "L"], np.int64)

    def set_hkls(self, hkl: np.ndarray) -> None:
        self["H"], self["K"], self["L"] = hkl[:, 0], hkl[:, 1], hkl[:, 2]

    def compute_dHKL(self, inplace: bool = True) -> "DataSet":
        ds = self if inplace else self.copy()
        ds["dHKL"] = ds.cell.compute_d(ds.get_hkls()).astype(np.float32)
        ds.mtz_dtypes.setdefault("dHKL", "R")
        return ds

    def remove_absences(self, inplace: bool = True) -> "DataSet":
        ds = self if inplace else self.copy()
        ds.drop_rows(ds.spacegroup.is_absent(ds.get_hkls()))
        return ds

    def hkl_to_asu(self, inplace: bool = True,
                   anomalous: bool = False) -> "DataSet":
        ds = self if inplace else self.copy()
        asu, _ = ds.spacegroup.map_to_asu(ds.get_hkls(), anomalous=anomalous)
        ds.set_hkls(asu)
        return ds

    def label_centrics(self, inplace: bool = True) -> "DataSet":
        ds = self if inplace else self.copy()
        ds["CENTRIC"] = ds.spacegroup.is_centric(ds.get_hkls())
        return ds

    def compute_multiplicity(self, inplace: bool = True) -> "DataSet":
        ds = self if inplace else self.copy()
        ds["EPSILON"] = ds.spacegroup.epsilon(ds.get_hkls()).astype(np.int32)
        ds.mtz_dtypes.setdefault("EPSILON", "I")
        return ds

    def write_mtz(self, path: str) -> None:
        from .mtz import write_mtz
        write_mtz(self, path)


def concat_datasets(datasets: Iterable[DataSet]) -> DataSet:
    """Rows of each DataSet in turn (the columns of the first, which every
    one must hold), with the first one's context."""
    datasets = list(datasets)
    if not datasets:
        return DataSet()
    first = datasets[0]
    return first._like({k: np.concatenate([d[k] for d in datasets])
                        for k in first.columns})
