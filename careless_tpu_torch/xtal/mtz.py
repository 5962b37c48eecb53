"""CCP4 MTZ binary reflection-file reader/writer in pure numpy.

The port's own copy of careless_tpu/xtal/mtz.py, on the port's numpy
DataSet: the reflection records are read with one np.frombuffer and written
with one tobytes, so a 1M-observation file takes no per-row Python; on the
same table the writer gives the JAX package's bytes.

Format: 4-byte magic "MTZ ", int32 word-offset of the header, machine stamp;
float32 reflection records from byte 80; 80-char ASCII header records
(VERS/NCOL/CELL/SYMINF/SYMM/COLUMN/.../END) at the header offset.
"""
from __future__ import annotations

import re
import struct
from typing import List, Optional

import numpy as np

from .cell import UnitCell
from .dataset import DataSet
from .symmetry import SpaceGroup
from .symop import Op

_MACHINE_STAMP = bytes([0x44, 0x41, 0x00, 0x00])  # little-endian IEEE

# MTZ column types that should surface as integers
_INT_TYPES = set("HBIY")


def read_mtz(path: str) -> DataSet:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"MTZ ":
        raise ValueError(f"{path}: not an MTZ file")
    (hdr_word,) = struct.unpack("<i", raw[4:8])
    hdr_start = (hdr_word - 1) * 4
    header = raw[hdr_start:]
    records = [header[i:i + 80].decode("ascii", "replace")
               for i in range(0, len(header) - len(header) % 80, 80)]

    ncol = nrefl = 0
    cell = None
    sg_num = None
    sg_name = None
    symops: List[Op] = []
    columns = []  # (label, type)
    for rec in records:
        tag = rec[:4].strip().upper()
        body = rec[4:].strip()
        if rec.startswith("NCOL"):
            parts = rec.split()
            ncol, nrefl = int(parts[1]), int(parts[2])
        elif rec.startswith("CELL") and not rec.startswith("DCELL"):
            vals = [float(x) for x in rec.split()[1:7]]
            cell = UnitCell(*vals)
        elif rec.startswith("SYMINF"):
            m = re.match(
                r"SYMINF\s+\d+\s+\d+\s+\S+\s+(\d+)\s+'([^']*)'", rec.strip())
            if m:
                sg_num = int(m.group(1))
                sg_name = m.group(2).strip()
            else:
                parts = rec.split()
                try:
                    sg_num = int(parts[4])
                except (IndexError, ValueError):
                    pass
        elif rec.startswith("SYMM"):
            symops.append(Op.from_xyz(rec[4:].strip()))
        elif rec.startswith("COLU"):
            parts = rec.split()
            columns.append((parts[1], parts[2]))
        elif rec.startswith("END") and not rec.startswith("MTZENDOFHEADERS"):
            break

    if len(columns) != ncol:
        raise ValueError(f"{path}: NCOL={ncol} but {len(columns)} COLUMN records")
    data = np.frombuffer(raw, dtype="<f4", count=ncol * nrefl, offset=80)
    data = data.reshape(nrefl, ncol)

    if symops:
        spacegroup = SpaceGroup(symops, number=sg_num, hm=sg_name)
    elif sg_num or sg_name:
        spacegroup = SpaceGroup.from_name(sg_num or sg_name)
    else:
        spacegroup = SpaceGroup.from_name("P 1")

    cols = {}
    mtz_dtypes = {}
    for j, (label, typ) in enumerate(columns):
        col = data[:, j]
        if typ in _INT_TYPES:
            cols[label] = np.round(col).astype(np.int32)
        else:
            cols[label] = col.astype(np.float32)
        mtz_dtypes[label] = typ
    ds = DataSet(cols, cell=cell, spacegroup=spacegroup,
                 mtz_dtypes=mtz_dtypes)

    # Unmerged convention: HKL are stored reduced to the ASU with the
    # original orientation in M/ISYM (ISYM = 2j+1 for h+, 2j+2 for h- under
    # header op j, 1-indexed in SYMM record order). Reconstruct the observed
    # indices like rs.read_mtz does — without this, Friedel separation and
    # Laue central-ray metadata silently collapse.
    if "M/ISYM" in ds.columns and symops:
        ds = _hkl_to_observed(ds, symops)
    return ds


def _hkl_to_observed(ds: DataSet, symops) -> DataSet:
    isym = ds["M/ISYM"].astype(np.int64) % 256
    j = np.clip((isym - 1) // 2, 0, len(symops) - 1)
    minus = (isym % 2 == 0) & (isym > 0)
    hkl = ds.to_numpy(["H", "K", "L"], np.int64)
    inv_rots = np.stack([op.inverse().rot_array for op in symops])  # (n,3,3)
    observed = np.einsum("ni,nij->nj", hkl, inv_rots[j])
    observed = np.where(minus[:, None], -observed, observed)
    ds["H"], ds["K"], ds["L"] = observed.T.astype(np.int32)
    return ds


def _rec(text: str) -> bytes:
    return text.ljust(80)[:80].encode("ascii")


_LAT_FROM_HALL = {"P": "P", "A": "A", "B": "B", "C": "C", "I": "I",
                  "R": "R", "F": "F"}


def _guess_type(label: str, values: np.ndarray) -> str:
    from .dataset import DEFAULT_MTZ_TYPES
    if label in DEFAULT_MTZ_TYPES:
        return DEFAULT_MTZ_TYPES[label]
    if np.issubdtype(values.dtype, np.integer):
        return "I" if label not in ("H", "K", "L") else "H"
    return "R"


def _hkl_to_stored(ds: DataSet, sg: SpaceGroup) -> DataSet:
    """Inverse of _hkl_to_observed: reduce observed HKL to the ASU and encode
    the orientation + Friedel parity in M/ISYM (unmerged MTZ convention)."""
    ops = list(sg.ops)
    hkl = ds.to_numpy(["H", "K", "L"], np.int64)
    asu, _ = sg.map_to_asu(hkl, anomalous=False)
    rots = np.stack([op.rot_array for op in ops])         # (n,3,3)
    eq = np.einsum("ni,oij->noj", hkl, rots)              # (N,n,3)
    plus_hit = np.all(eq == asu[:, None, :], axis=-1)     # (N,n)
    minus_hit = np.all(-eq == asu[:, None, :], axis=-1)
    j_plus = np.argmax(plus_hit, axis=1)
    j_minus = np.argmax(minus_hit, axis=1)
    has_plus = plus_hit.any(axis=1)
    isym = np.where(has_plus, 2 * j_plus + 1, 2 * j_minus + 2)
    out = ds.copy()
    out["H"], out["K"], out["L"] = asu.T.astype(np.int32)
    m = out["M/ISYM"].astype(np.int64) // 256  # preserve partiality flag
    out["M/ISYM"] = (256 * m + isym).astype(np.int32)
    return out


def write_mtz(ds: DataSet, path: str, title: str = "careless-tpu") -> None:
    sg: Optional[SpaceGroup] = ds.spacegroup or SpaceGroup.from_name("P 1")
    cell: UnitCell = ds.cell or UnitCell(1, 1, 1)
    if "M/ISYM" in ds.columns and sg is not None:
        ds = _hkl_to_stored(ds, sg)
    cols = list(ds.columns)
    nrefl = len(ds)
    ncol = len(cols)
    mtz_dtypes = dict(getattr(ds, "mtz_dtypes", {}))

    data = np.empty((nrefl, ncol), dtype="<f4")
    types = []
    for j, label in enumerate(cols):
        vals = ds[label]
        types.append(mtz_dtypes.get(label) or _guess_type(label, vals))
        data[:, j] = vals.astype(np.float32)

    # point-group ops count (nsymp) = primitive ops; nsym = all ops
    nsym = sg.n_ops
    nsymp = sg.point_group_order if sg.centrosymmetric is False else sg.point_group_order
    # lattice type from first centering translation count
    n_centering = nsym // max(1, len({op.rot for op in sg.ops}))
    lat = {1: "P", 2: "C", 3: "R", 4: "F"}.get(n_centering, "P")
    if sg.hm:
        lat = sg.hm.split()[0].lstrip("-").upper()[:1] or lat
    sg_num = sg.number or 0
    sg_name = sg.hm or "P 1"
    pg_name = "PG" + re.sub(r"[\s/]", "", sg_name.split(" ", 1)[-1]) if sg_name else "PG1"

    records = [
        _rec("VERS MTZ:V1.1"),
        _rec(f"TITLE {title}"),
        _rec(f"NCOL {ncol:8d} {nrefl:12d} {0:8d}"),
        _rec("CELL  {:9.4f} {:9.4f} {:9.4f} {:9.4f} {:9.4f} {:9.4f}".format(
            *cell.parameters)),
        _rec("SORT    0   0   0   0   0"),
        _rec(f"SYMINF {nsym:3d} {nsymp:3d} {lat} {sg_num:5d}"
             f"            '{sg_name}' {pg_name}"),
    ]
    for op in sg.ops:
        records.append(_rec("SYMM " + op.to_xyz().upper()))
    if "H" in cols and nrefl:
        d = cell.compute_d(ds.to_numpy(["H", "K", "L"], np.int64))
        dmin, dmax = float(np.min(d)), float(np.max(d))
        records.append(_rec(f"RESO {1.0 / dmax**2:.12f}  {1.0 / dmin**2:.12f}"))
    records.append(_rec("VALM NAN"))
    for label, typ in zip(cols, types):
        vals = data[:, cols.index(label)]
        finite = vals[np.isfinite(vals)]
        vmin = float(finite.min()) if finite.size else 0.0
        vmax = float(finite.max()) if finite.size else 0.0
        records.append(_rec(
            f"COLUMN {label:<30s} {typ} {vmin:17.9f} {vmax:17.9f}    0"))
    records += [
        _rec("NDIF        1"),
        _rec("PROJECT       0 careless_tpu"),
        _rec("CRYSTAL       0 careless_tpu"),
        _rec("DATASET       0 careless_tpu"),
        _rec("DCELL         0 {:9.4f} {:9.4f} {:9.4f} {:9.4f} {:9.4f} {:9.4f}".format(
            *cell.parameters)),
        _rec("DWAVEL        0    0.00000"),
        _rec("END"),
        _rec("MTZENDOFHEADERS"),
    ]

    body = data.tobytes()
    hdr_word = (80 + len(body)) // 4 + 1
    with open(path, "wb") as f:
        f.write(b"MTZ ")
        f.write(struct.pack("<i", hdr_word))
        f.write(_MACHINE_STAMP)
        f.write(b"\x00" * (80 - 12))
        f.write(body)
        f.write(b"".join(records))
