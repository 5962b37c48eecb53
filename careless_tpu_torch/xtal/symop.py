"""Symmetry operations for crystallographic space groups.

The port's own copy of careless_tpu/xtal/symop.py: triplet parsing,
operator algebra and group closure.

An operation is ``x' = R @ x + t`` acting on fractional coordinates, with R an
integer 3x3 matrix and t a translation stored in units of 1/24 (DEN) so all
crystallographic translations (1/2, 1/3, 1/4, 1/6, 1/8) are exact integers.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterable, List, Sequence, Tuple

import numpy as np

DEN = 24  # translation denominator; divisible by 2,3,4,6,8,12


@dataclass(frozen=True)
class Op:
    """A space-group operation: rotation (int 3x3, tuple) + translation (24ths)."""

    rot: Tuple[Tuple[int, int, int], ...]
    trans: Tuple[int, int, int]

    # ---------------------------------------------------------- constructors
    @staticmethod
    def identity() -> "Op":
        return Op(((1, 0, 0), (0, 1, 0), (0, 0, 1)), (0, 0, 0))

    @staticmethod
    def from_arrays(rot: np.ndarray, trans: np.ndarray) -> "Op":
        r = tuple(tuple(int(v) for v in row) for row in np.asarray(rot))
        t = tuple(int(v) % DEN for v in np.asarray(trans))
        return Op(r, t)

    # ------------------------------------------------------------- properties
    @property
    def rot_array(self) -> np.ndarray:
        return np.array(self.rot, dtype=np.int64)

    @property
    def trans_array(self) -> np.ndarray:
        return np.array(self.trans, dtype=np.int64)

    def det(self) -> int:
        return int(round(np.linalg.det(self.rot_array)))

    def is_identity(self) -> bool:
        return self == Op.identity()

    # -------------------------------------------------------------- algebra
    def __mul__(self, other: "Op") -> "Op":
        """Compose: (self * other)(x) = self(other(x))."""
        r = self.rot_array @ other.rot_array
        t = self.rot_array @ other.trans_array + self.trans_array
        return Op.from_arrays(r, t % DEN)

    def inverse(self) -> "Op":
        r = self.rot_array
        det = int(round(np.linalg.det(r)))
        if det not in (1, -1):
            raise ValueError(f"non-unimodular rotation, det={det}")
        # adjugate / det gives an integer inverse for det = +/-1
        inv = np.round(np.linalg.inv(r) * det).astype(np.int64) * det
        t = (-inv @ self.trans_array) % DEN
        return Op.from_arrays(inv, t)

    def translated(self, extra: Sequence[int]) -> "Op":
        t = (self.trans_array + np.asarray(extra, dtype=np.int64)) % DEN
        return Op.from_arrays(self.rot_array, t)

    def rot_only(self) -> "Op":
        return Op(self.rot, (0, 0, 0))

    # ------------------------------------------------------------ triplets
    _TERM_RE = re.compile(
        r"([+-]?)\s*(?:(\d+)\s*/\s*(\d+)|(\d*\.\d+)|(\d+))?\s*([xyzXYZ]?)"
    )

    @staticmethod
    def from_xyz(triplet: str) -> "Op":
        """Parse a triplet like ``-Y,X-Y,Z+1/3`` or ``1/2+x,y,z``."""
        rows = triplet.split(",")
        if len(rows) != 3:
            raise ValueError(f"bad triplet: {triplet!r}")
        rot = np.zeros((3, 3), dtype=np.int64)
        trans = np.zeros(3, dtype=np.int64)
        axes = {"x": 0, "y": 1, "z": 2}
        for i, row in enumerate(rows):
            row = row.strip()
            pos = 0
            while pos < len(row):
                m = Op._TERM_RE.match(row, pos)
                if not m or m.end() == pos:
                    raise ValueError(f"bad term in triplet {triplet!r} at {row[pos:]!r}")
                sign = -1 if m.group(1) == "-" else 1
                num, den, dec, integer, axis = (
                    m.group(2), m.group(3), m.group(4), m.group(5), m.group(6),
                )
                if axis:
                    coeff = 1
                    if integer:
                        coeff = int(integer)
                    elif num:
                        raise ValueError(f"fractional coefficient on axis: {triplet!r}")
                    rot[i, axes[axis.lower()]] += sign * coeff
                else:
                    if num:
                        frac = Fraction(int(num), int(den))
                    elif dec:
                        frac = Fraction(dec).limit_denominator(DEN)
                    elif integer:
                        frac = Fraction(int(integer))
                    else:
                        raise ValueError(f"empty term in triplet {triplet!r}")
                    val = frac * DEN
                    if val.denominator != 1:
                        raise ValueError(f"translation not in 1/{DEN}ths: {triplet!r}")
                    trans[i] += sign * int(val)
                pos = m.end()
                # skip over whitespace between terms
                while pos < len(row) and row[pos].isspace():
                    pos += 1
        return Op.from_arrays(rot, trans % DEN)

    def to_xyz(self) -> str:
        """Format as a triplet string, e.g. ``-y,x-y,z+1/3``."""
        out = []
        names = "xyz"
        for i in range(3):
            parts = ""
            for j in range(3):
                c = self.rot[i][j]
                if c == 0:
                    continue
                s = "+" if c > 0 else "-"
                mag = abs(c)
                coeff = "" if mag == 1 else str(mag)
                parts += f"{s}{coeff}{names[j]}"
            t = self.trans[i] % DEN
            if t:
                frac = Fraction(t, DEN)
                parts += f"+{frac.numerator}/{frac.denominator}"
            if not parts:
                parts = "0"
            if parts.startswith("+"):
                parts = parts[1:]
            out.append(parts)
        return ",".join(out)

    # ------------------------------------------------------- reflection math
    def apply_to_hkl(self, hkl: np.ndarray) -> np.ndarray:
        """h' = h @ R (row-vector convention; transpose action on Miller indices)."""
        return np.asarray(hkl, dtype=np.int64) @ self.rot_array

    def phase_shift(self, hkl: np.ndarray) -> np.ndarray:
        """Phase shift -2*pi*h.t (in cycles, i.e. h.t as a float)."""
        return np.asarray(hkl, dtype=np.float64) @ (self.trans_array / DEN)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Op({self.to_xyz()!r})"


def close_group(generators: Iterable[Op], limit: int = 1536) -> List[Op]:
    """Generate the full group by closure over composition."""
    ops = [Op.identity()]
    seen = {ops[0]}
    frontier = [g for g in generators]
    for g in frontier:
        if g not in seen:
            seen.add(g)
            ops.append(g)
    changed = True
    while changed:
        changed = False
        current = list(ops)
        for a in current:
            for b in current:
                c = a * b
                if c not in seen:
                    seen.add(c)
                    ops.append(c)
                    changed = True
                    if len(ops) > limit:
                        raise ValueError("group closure exceeded limit; bad generators?")
    return ops
