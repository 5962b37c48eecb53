"""Hall symbol parser: concise space-group notation -> generator list -> full group.

The port's own copy of careless_tpu/xtal/hall.py. Hall symbols (S.R. Hall, Acta
Cryst. A37, 517 (1981)) encode lattice centering, generators with axis
directions and translations, and the origin — sufficient to *generate* every
space group rather than tabulate its operators.
"""
from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Tuple

import numpy as np

from .symop import DEN, Op, close_group

# principal rotation matrices about z, by order
_ROT_Z = {
    1: np.eye(3, dtype=np.int64),
    2: np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], dtype=np.int64),
    3: np.array([[0, -1, 0], [1, -1, 0], [0, 0, 1]], dtype=np.int64),
    4: np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.int64),
    6: np.array([[1, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.int64),
}
# cyclic axis permutation x->y->z->x ; conjugation moves the rotation axis
_CYC = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.int64)

# 2-fold rotations about face diagonals, keyed by (preceding principal axis, ' or ")
_DIAG = {
    ("z", "'"): np.array([[0, -1, 0], [-1, 0, 0], [0, 0, -1]], dtype=np.int64),
    ("z", '"'): np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], dtype=np.int64),
    ("x", "'"): np.array([[-1, 0, 0], [0, 0, -1], [0, -1, 0]], dtype=np.int64),
    ("x", '"'): np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=np.int64),
    ("y", "'"): np.array([[0, 0, -1], [0, -1, 0], [-1, 0, 0]], dtype=np.int64),
    ("y", '"'): np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.int64),
}

_LATTICE_TRANSLATIONS = {
    "P": [(0, 0, 0)],
    "A": [(0, 0, 0), (0, DEN // 2, DEN // 2)],
    "B": [(0, 0, 0), (DEN // 2, 0, DEN // 2)],
    "C": [(0, 0, 0), (DEN // 2, DEN // 2, 0)],
    "I": [(0, 0, 0), (DEN // 2, DEN // 2, DEN // 2)],
    "R": [
        (0, 0, 0),
        (2 * DEN // 3, DEN // 3, DEN // 3),
        (DEN // 3, 2 * DEN // 3, 2 * DEN // 3),
    ],
    "F": [
        (0, 0, 0),
        (0, DEN // 2, DEN // 2),
        (DEN // 2, 0, DEN // 2),
        (DEN // 2, DEN // 2, 0),
    ],
}

_TRANSLATION_SYMBOLS = {
    "a": (DEN // 2, 0, 0),
    "b": (0, DEN // 2, 0),
    "c": (0, 0, DEN // 2),
    "n": (DEN // 2, DEN // 2, DEN // 2),
    "u": (DEN // 4, 0, 0),
    "v": (0, DEN // 4, 0),
    "w": (0, 0, DEN // 4),
    "d": (DEN // 4, DEN // 4, DEN // 4),
}

_AXIS_VEC = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}

_TERM_RE = re.compile(r"(-?)([12346])([xyz'\"*]?)((?:[abcnuvwd]|[1-5])*)")


def _axis_rotation(order: int, axis: str, preceding: str) -> np.ndarray:
    if axis == "*":
        if order != 3:
            raise ValueError("* axis only valid for 3-fold rotations")
        return _CYC.copy()
    if axis in ("'", '"'):
        if order != 2:
            raise ValueError("diagonal axes only valid for 2-fold rotations")
        return _DIAG[(preceding, axis)].copy()
    base = _ROT_Z[order]
    if axis == "z":
        return base.copy()
    if axis == "x":
        return _CYC @ base @ _CYC.T
    if axis == "y":
        return _CYC @ _CYC @ base @ _CYC.T @ _CYC.T
    raise ValueError(f"bad axis {axis!r}")


def parse_hall(symbol: str) -> List[Op]:
    """Parse a Hall symbol and return the complete list of group operations."""
    s = symbol.strip()
    # origin shift "(v1 v2 v3)" in 12ths
    shift = np.zeros(3, dtype=np.int64)
    m = re.search(r"\(([^)]*)\)\s*$", s)
    if m:
        parts = m.group(1).split()
        if len(parts) != 3:
            raise ValueError(f"bad origin shift in {symbol!r}")
        for i, p in enumerate(parts):
            fr = Fraction(p) * DEN / 12
            if fr.denominator != 1:
                raise ValueError(f"bad origin shift in {symbol!r}")
            shift[i] = int(fr)
        s = s[: m.start()].strip()

    tokens = s.split()
    if not tokens:
        raise ValueError("empty Hall symbol")
    lat = tokens[0]
    centrosymmetric = lat.startswith("-")
    if centrosymmetric:
        lat = lat[1:]
    lat = lat.upper()
    if lat not in _LATTICE_TRANSLATIONS:
        raise ValueError(f"unknown lattice symbol {lat!r} in {symbol!r}")

    generators: List[Op] = []
    preceding_order = 0
    preceding_axis = "z"
    for idx, tok in enumerate(tokens[1:]):
        m = _TERM_RE.fullmatch(tok.lower())
        if not m:
            raise ValueError(f"bad Hall term {tok!r} in {symbol!r}")
        improper = m.group(1) == "-"
        order = int(m.group(2))
        axis = m.group(3)
        tsyms = m.group(4)

        if not axis:
            if order == 1:
                axis = "z"
            elif idx == 0:
                axis = "z"
            elif order == 2:
                if preceding_order in (2, 4):
                    axis = "x"
                elif preceding_order in (3, 6):
                    axis = "'"
                else:
                    axis = "x"
            elif order == 3:
                axis = "*"
            else:
                axis = "z"

        rot = _axis_rotation(order, axis, preceding_axis)
        if improper:
            rot = -rot

        trans = np.zeros(3, dtype=np.int64)
        for ch in tsyms:
            if ch.isdigit():
                sub = int(ch)
                if axis not in _AXIS_VEC:
                    raise ValueError(
                        f"subscript translation needs principal axis: {tok!r}"
                    )
                vec = np.array(_AXIS_VEC[axis], dtype=np.int64)
                frac = Fraction(sub, order) * DEN
                if frac.denominator != 1:
                    raise ValueError(f"bad subscript {sub} for order {order}")
                trans += int(frac) * vec
            else:
                trans += np.array(_TRANSLATION_SYMBOLS[ch], dtype=np.int64)

        generators.append(Op.from_arrays(rot, trans % DEN))
        if order != 1:
            preceding_order = order
            if axis in _AXIS_VEC:
                preceding_axis = axis

    if centrosymmetric:
        generators.append(Op.from_arrays(-np.eye(3, dtype=np.int64), (0, 0, 0)))
    for t in _LATTICE_TRANSLATIONS[lat][1:]:
        generators.append(Op.from_arrays(np.eye(3, dtype=np.int64), t))

    ops = close_group(generators)

    if shift.any():
        # op' = T(v) op T(-v)
        ops = [
            Op.from_arrays(
                op.rot_array,
                (op.trans_array + shift - op.rot_array @ shift) % DEN,
            )
            for op in ops
        ]
    # canonical ordering: identity first, then by (det desc, trace desc, rot, trans)
    ident = Op.identity()
    ops.sort(key=lambda o: (not o.is_identity(), -o.det(), o.rot, o.trans))
    assert ops[0] == ident
    return ops
