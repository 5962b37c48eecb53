"""Space-group symmetry engine: reciprocal-space queries over Miller indices.

The port's own copy of careless_tpu/xtal/symmetry.py: centric flags and
epsilon factors, systematic absences, hkl -> ASU mapping with Friedel
separation, and reciprocal ASU generation.

All queries are vectorized numpy over (N, 3) int arrays; this is host-side
preprocessing that runs once per job before any device computation.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .hall import parse_hall
from .sg_tables import lookup_hall
from .symop import DEN, Op


# --------------------------------------------------------------------------
# Reciprocal-space ASU conditions per Laue class (CCP4/sgtbx conventions).
# Each entry maps a Laue-class tag to a vectorized predicate over (h, k, l).
# Conditions are *verified at group-construction time* by an exact tiling
# check (each symmetry orbit on a test grid must contain exactly one member
# satisfying the condition); if no tabulated condition tiles (exotic
# settings), we fall back to lexicographic-max canonicalization.
# --------------------------------------------------------------------------
def _asu_m1(h, k, l):  # -1
    return (l > 0) | ((l == 0) & ((h > 0) | ((h == 0) & (k >= 0))))


def _asu_2m(h, k, l):  # 2/m (b unique)
    return (k >= 0) & ((l > 0) | ((l == 0) & (h >= 0)))


def _asu_2m_c(h, k, l):  # 2/m (c unique)
    return (l >= 0) & ((k > 0) | ((k == 0) & (h >= 0)))


def _asu_mmm(h, k, l):  # mmm
    return (h >= 0) & (k >= 0) & (l >= 0)


def _asu_4m(h, k, l):  # 4/m
    return (l >= 0) & (((h >= 0) & (k > 0)) | ((h == 0) & (k == 0)))


def _asu_4mmm(h, k, l):  # 4/mmm
    return (h >= k) & (k >= 0) & (l >= 0)


def _asu_3(h, k, l):  # -3
    return ((h >= 0) & (k > 0)) | ((h == 0) & (k == 0) & (l >= 0))


def _asu_3m1(h, k, l):  # -3m1 (2-folds along a,b)
    return (h >= k) & (k >= 0) & ((k > 0) | (l >= 0))


def _asu_31m(h, k, l):  # -31m (2-folds perpendicular to a,b)
    return (h >= k) & (k >= 0) & ((h > k) | (l >= 0))


def _asu_6m(h, k, l):  # 6/m
    return (l >= 0) & (((h >= 0) & (k > 0)) | ((h == 0) & (k == 0)))


def _asu_6mmm(h, k, l):  # 6/mmm
    return (h >= k) & (k >= 0) & (l >= 0)


def _asu_m3(h, k, l):  # m-3
    return (h >= 0) & (k >= 0) & (l >= 0) & (
        ((l >= h) & (k > h)) | ((l == h) & (k == h))
    )


def _asu_m3m(h, k, l):  # m-3m
    return (k >= l) & (l >= 0) & (h >= k)


_ASU_CANDIDATES: List[Callable] = [
    _asu_m1, _asu_2m, _asu_2m_c, _asu_mmm, _asu_4m, _asu_4mmm,
    _asu_3, _asu_3m1, _asu_31m, _asu_6m, _asu_6mmm, _asu_m3, _asu_m3m,
]

# candidate order to try, keyed by Laue-group order (cheap pre-filter)
_ASU_BY_ORDER = {
    2: [_asu_m1],
    4: [_asu_2m, _asu_2m_c, _asu_mmm],
    8: [_asu_mmm, _asu_4m, _asu_2m, _asu_2m_c],
    16: [_asu_4mmm],
    6: [_asu_3],
    12: [_asu_3m1, _asu_31m, _asu_6m],
    24: [_asu_6mmm, _asu_m3],
    48: [_asu_m3m],
}


class SpaceGroup:
    """A crystallographic space group built from explicit operators."""

    def __init__(self, ops: Sequence[Op], number: Optional[int] = None,
                 hm: Optional[str] = None, hall: Optional[str] = None):
        if not ops or not ops[0].is_identity():
            ops = sorted(ops, key=lambda o: (not o.is_identity(), -o.det(), o.rot, o.trans))
        if not ops or not ops[0].is_identity():
            raise ValueError("space group must contain the identity")
        self.ops: Tuple[Op, ...] = tuple(ops)
        self.number = number
        self.hm = hm
        self.hall = hall
        # unique rotation parts define the point group (h' = h @ R action)
        seen = {}
        for op in self.ops:
            seen.setdefault(op.rot, op)
        self._point_ops = tuple(seen.values())
        self._rot_stack = np.stack([op.rot_array for op in self._point_ops])  # (P,3,3)
        self._trans_by_rot = {
            op.rot: [o.trans_array for o in self.ops if o.rot == op.rot]
            for op in self._point_ops
        }
        self.centrosymmetric = any(
            np.array_equal(op.rot_array, -np.eye(3, dtype=np.int64))
            for op in self._point_ops
        )
        # Laue group rotations: point ops plus Friedel
        laue = {}
        for op in self._point_ops:
            laue.setdefault(op.rot, op.rot_array)
            neg = tuple(tuple(int(-v) for v in row) for row in op.rot)
            laue.setdefault(neg, -op.rot_array)
        self._laue_stack = np.stack(list(laue.values()))  # (L,3,3)
        self._asu_condition = self._select_asu_condition()

    # -------------------------------------------------------------- factory
    @classmethod
    def from_hall(cls, hall: str) -> "SpaceGroup":
        return cls(parse_hall(hall), hall=hall)

    @classmethod
    @lru_cache(maxsize=256)
    def from_name(cls, key) -> "SpaceGroup":
        hall, number, hm = lookup_hall(key)
        sg = cls(parse_hall(hall), number=number, hm=hm, hall=hall)
        return sg

    @classmethod
    def from_xyz_ops(cls, triplets: Sequence[str], number: Optional[int] = None,
                     hm: Optional[str] = None) -> "SpaceGroup":
        return cls([Op.from_xyz(t) for t in triplets], number=number, hm=hm)

    # ------------------------------------------------------------ properties
    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def point_group_order(self) -> int:
        return len(self._point_ops)

    @property
    def laue_group_order(self) -> int:
        return len(self._laue_stack)

    def xyz_ops(self) -> List[str]:
        return [op.to_xyz() for op in self.ops]

    # --------------------------------------------------------- hkl queries
    def _equivalents(self, hkl: np.ndarray, friedel: bool) -> np.ndarray:
        """(N, n_sym, 3) array of symmetry equivalents h' = h @ R."""
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.int64))
        stack = self._laue_stack if friedel else self._rot_stack
        return np.einsum("ni,sij->nsj", hkl, stack)

    def is_centric(self, hkl: np.ndarray) -> np.ndarray:
        """True where some op maps h -> -h (phase-restricted reflections)."""
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.int64))
        eq = self._equivalents(hkl, friedel=False)  # (N,P,3)
        return np.any(np.all(eq == -hkl[:, None, :], axis=-1), axis=-1)

    def epsilon(self, hkl: np.ndarray) -> np.ndarray:
        """Multiplicity factor: # point ops with h @ R == h."""
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.int64))
        eq = self._equivalents(hkl, friedel=False)
        return np.sum(np.all(eq == hkl[:, None, :], axis=-1), axis=-1).astype(np.int64)

    def is_absent(self, hkl: np.ndarray) -> np.ndarray:
        """Systematic absences: exists (R,t) with hR == h and h.t not integral."""
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.int64))
        absent = np.zeros(len(hkl), dtype=bool)
        for op in self.ops:
            eq = hkl @ op.rot_array
            fixed = np.all(eq == hkl, axis=-1)
            if not fixed.any():
                continue
            phase = (hkl @ op.trans_array) % DEN
            absent |= fixed & (phase != 0)
        return absent

    # ------------------------------------------------------------- ASU math
    def _select_asu_condition(self) -> Callable:
        order = self.laue_group_order
        candidates = _ASU_BY_ORDER.get(order, []) + [
            c for c in _ASU_CANDIDATES if c not in _ASU_BY_ORDER.get(order, [])
        ]
        grid = np.mgrid[-4:5, -4:5, -4:5].reshape(3, -1).T.astype(np.int64)
        eq = self._equivalents(grid, friedel=True)  # (N,L,3)
        for cond in candidates:
            inside = cond(eq[..., 0], eq[..., 1], eq[..., 2])  # (N,L)
            # exactly one member of each orbit in the ASU: per-point, the
            # number of (op, in-asu) hits must equal the orbit stabilizer size
            # == number of ops mapping h to a fixed image. Equivalent exact
            # check: the set of in-ASU images must be a single unique index.
            ok = True
            for i in range(0, len(grid), 243):
                sl = slice(i, i + 243)
                imgs = eq[sl]
                ins = inside[sl]
                for j in range(imgs.shape[0]):
                    sel = imgs[j][ins[j]]
                    if len(sel) == 0 or len(np.unique(sel, axis=0)) != 1:
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return cond
        return None  # fall back to lexicographic-max

    def _canonical_index(self, eq: np.ndarray) -> np.ndarray:
        """Pick the canonical equivalent per row of (N, S, 3); returns (N,) idx."""
        if self._asu_condition is not None:
            inside = self._asu_condition(eq[..., 0], eq[..., 1], eq[..., 2])
            # first in-ASU hit
            return np.argmax(inside, axis=-1)
        # lexicographic max over (h,k,l)
        key = ((eq[..., 0].astype(np.int64) * 4096) + eq[..., 1]) * 4096 + eq[..., 2]
        return np.argmax(key, axis=-1)

    def map_to_asu(self, hkl: np.ndarray, anomalous: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Map Miller indices into the reciprocal-space ASU.

        Returns (hkl_asu, friedel_minus). With ``anomalous=True``, acentric
        Friedel-minus observations come back as ``-h_asu`` (matching rs
        hkl_to_asu(anomalous=True)) and
        friedel_minus marks them.
        """
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.int64))
        eq_point = self._equivalents(hkl, friedel=False)  # (N,P,3)
        P = eq_point.shape[1]
        eq = np.concatenate([eq_point, -eq_point], axis=1)  # (N,2P,3): +Friedel
        idx = self._canonical_index(eq)
        out = eq[np.arange(len(hkl)), idx]
        fminus = idx >= P
        centric = self.is_centric(hkl)
        fminus = fminus & ~centric
        if anomalous:
            out = np.where(fminus[:, None], -out, out)
        return out, fminus

    def generate_reciprocal_asu(self, cell, dmin: float, anomalous: bool = False
                                ) -> np.ndarray:
        """All unique non-absent Miller indices in the ASU to resolution dmin.

        With anomalous=True, acentric reflections appear twice (h and -h),
        mirroring rs.utils.generate_reciprocal_asu.
        Sorted in C order by (h, k, l) for determinism.
        """
        hmax = np.maximum(1, np.floor(
            np.array([cell.a, cell.b, cell.c]) / dmin).astype(np.int64) + 1)
        grid = np.mgrid[-hmax[0]:hmax[0] + 1,
                        -hmax[1]:hmax[1] + 1,
                        -hmax[2]:hmax[2] + 1].reshape(3, -1).T.astype(np.int64)
        grid = grid[np.any(grid != 0, axis=1)]
        # f32 rounding must match DataSet.compute_dHKL so an observation at
        # exactly dmin is never excluded from the generated ASU
        d = cell.compute_d(grid).astype(np.float32)
        grid = grid[d >= np.float32(dmin)]
        asu, _ = self.map_to_asu(grid, anomalous=False)
        uniq = np.unique(asu, axis=0)
        uniq = uniq[~self.is_absent(uniq)]
        if anomalous:
            acentric = ~self.is_centric(uniq)
            minus = -uniq[acentric]
            uniq = np.concatenate([uniq, minus], axis=0)
        # sort lexicographically by (h, k, l)
        order = np.lexsort((uniq[:, 2], uniq[:, 1], uniq[:, 0]))
        return uniq[order]

    def __repr__(self) -> str:  # pragma: no cover
        tag = self.hm or self.hall or f"{self.n_ops} ops"
        return f"SpaceGroup({tag!r}, n_ops={self.n_ops})"

    def __eq__(self, other) -> bool:
        return isinstance(other, SpaceGroup) and set(self.ops) == set(other.ops)

    def __hash__(self) -> int:
        return hash(frozenset(self.ops))
