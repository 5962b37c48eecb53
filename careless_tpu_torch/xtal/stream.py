"""CrystFEL .stream reader.

Counterpart of careless_tpu/xtal/stream.py. read_crystfel parses with the
native C++ parser (xtal/_native.py, this package's cpp/stream_parser.cc,
built at its first use) and takes the pure-Python reader,
`_read_crystfel_python`, only where no host C++ compiler exists, saying
so; `last_parser` names the parser of the last read ("native" or
"python"). The two parsers are the JAX package's two, each as it is: they
part on streams the Python reader reads otherwise (the C++ keeps the first
unit-cell block and carries a crystal's astar/bstar/cstar over to the next
that lacks them, for example). One row per measured reflection, with the
stream metadata columns of careless' mono formatter:

  H K L I SigI BATCH  s1x s1y s1z  ewald_offset angular_ewald_offset XDET
  YDET Wavelength

BATCH counts crystals from 0. The cell comes from the stream's header; the
space group is the caller's (the CLI's --spacegroups), since a stream names
none. Geometry: each crystal's reciprocal basis A* (the astar, bstar, cstar
rows, nm^-1 -> 1/Angstrom) gives the scattering vector svec = hkl @ A*;
with the beam along +z, s0 = (0, 0, 1/lambda) and s1 = svec + s0. The Ewald
offset is e = |s1| - 1/lambda (1/Angstrom) and the angular offset
degrees(arcsin(e / |s1|)). Either parser computes every value in float64 as
the JAX package's parser of its kind does, then stores it in float32, so
the columns equal that parser's bit for bit.
"""
from __future__ import annotations

import re
import warnings
from typing import Optional

import numpy as np

from . import _native
from .cell import UnitCell
from .dataset import DataSet

_HC_EV_A = 12398.419843320026  # h*c in eV*Angstrom

_CELL_LINE = re.compile(r"\s*(a|b|c|al|be|ga)\s*=\s*([0-9.+-eE]+)")
_CELL_KEYS = ["a", "b", "c", "al", "be", "ga"]


def _parse_vec(line: str) -> np.ndarray:
    # e.g. "astar = +0.0279588 -0.1224762 -0.0092915 nm^-1"
    parts = line.split("=")[1].split()
    return np.array([float(parts[0]), float(parts[1]), float(parts[2])])


# the parser of the last read_crystfel: "native" or "python"
last_parser: Optional[str] = None


def read_crystfel(path: str, spacegroup=None) -> DataSet:
    """The indexed reflections of every crystal in a CrystFEL stream, by
    the native parser, or by the Python reader where no compiler exists."""
    global last_parser
    try:
        arrays, cell_params = _native.parse_stream(path)
    except _native.NoCompiler as e:
        warnings.warn(f"{e}; reading {path} with the Python parser")
        last_parser = "python"
        return _read_crystfel_python(path, spacegroup)
    last_parser = "native"
    return _assemble(arrays, cell_params, spacegroup)


def _read_crystfel_python(path: str, spacegroup=None) -> DataSet:
    header_cell = [None] * 6
    rows_h = []
    rows_i = []
    rows_meta = []  # per-reflection (batch, svec, s1, eo, aeo, fs, ss, lam)

    batch = -1
    photon_energy = None
    astar = bstar = cstar = None
    amat = lam = None
    in_refls = False
    in_header_cell = False

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("----- Begin unit cell"):
                in_header_cell = True
            elif line.startswith("----- End unit cell"):
                in_header_cell = False
            elif in_header_cell:
                m = _CELL_LINE.match(line)
                if m:
                    header_cell[_CELL_KEYS.index(m.group(1))] = \
                        float(m.group(2))
            elif line.startswith("photon_energy_eV"):
                photon_energy = float(line.split("=")[1])
            elif line.startswith("--- Begin crystal"):
                batch += 1
                astar = bstar = cstar = None
            elif line.startswith("astar ="):
                astar = _parse_vec(line) / 10.0  # nm^-1 -> 1/A
            elif line.startswith("bstar ="):
                bstar = _parse_vec(line) / 10.0
            elif line.startswith("cstar ="):
                cstar = _parse_vec(line) / 10.0
            elif line.startswith("Reflections measured after indexing"):
                in_refls = True
                amat = np.stack([astar, bstar, cstar])  # rows
                lam = _HC_EV_A / photon_energy
            elif line.startswith("End of reflections"):
                in_refls = False
            elif in_refls and not line.strip().startswith("h "):
                parts = line.split()
                if len(parts) < 9:
                    continue
                h, k, l = int(parts[0]), int(parts[1]), int(parts[2])
                svec = np.array([h, k, l], dtype=np.float64) @ amat
                s1 = svec + np.array([0.0, 0.0, 1.0 / lam])
                s1n = np.linalg.norm(s1)
                eo = s1n - 1.0 / lam
                aeo = np.degrees(np.arcsin(np.clip(eo / s1n, -1.0, 1.0)))
                rows_h.append((h, k, l))
                rows_i.append((float(parts[3]), float(parts[4])))
                rows_meta.append((batch, *svec, *s1, eo, aeo,
                                  float(parts[7]), float(parts[8]), lam))

    if not rows_h:
        raise ValueError(f"{path}: no indexed reflections found")
    hkl = np.array(rows_h, dtype=np.int32)
    inten = np.array(rows_i, dtype=np.float32)
    meta = np.array(rows_meta, dtype=np.float32)
    arrays = {
        "H": hkl[:, 0], "K": hkl[:, 1], "L": hkl[:, 2],
        "I": inten[:, 0], "SigI": inten[:, 1],
        "BATCH": meta[:, 0].astype(np.int32),
        "s1x": meta[:, 4], "s1y": meta[:, 5], "s1z": meta[:, 6],
        "ewald_offset": meta[:, 7],
        "angular_ewald_offset": meta[:, 8],
        "XDET": meta[:, 9], "YDET": meta[:, 10],
        "Wavelength": meta[:, 11],
    }
    return _assemble(arrays, header_cell, spacegroup)


def _assemble(arrays, cell_params, spacegroup) -> DataSet:
    cell = None
    if cell_params is not None and all(v is not None for v in cell_params):
        cell = UnitCell(*cell_params)
    return DataSet(arrays, cell=cell, spacegroup=spacegroup,
                   mtz_dtypes={"H": "H", "K": "H", "L": "H", "I": "J",
                               "SigI": "Q", "BATCH": "B", "s1x": "R",
                               "s1y": "R", "s1z": "R", "ewald_offset": "R",
                               "angular_ewald_offset": "R", "XDET": "R",
                               "YDET": "R", "Wavelength": "R"})
