"""Convert XDS HKL files (INTEGRATE.HKL / XDS_ASCII.HKL) to MTZ.

    python -m careless_tpu_torch.xtal.xds XDS_ASCII.HKL out.mtz
    careless-tpu-torch.xds2mtz INTEGRATE.HKL out.mtz -s 19

Counterpart of careless_tpu/xtal/xds.py without pandas: the cell, space
group and column table come from the ``!`` header, BATCH is the rounded z
centroid, and the unmerged reflections are written as an MTZ. The records
are parsed with numpy as pandas' read_csv(sep=r"\\s+", comment="!") parses
them: text after a "!" is dropped, blank lines are skipped, and a column
whose every field is an integer is int64, else float64 (correctly rounded).
The MTZ stores float32 of those values, the JAX package's file byte for
byte.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .cell import UnitCell
from .dataset import DataSet
from .mtz import write_mtz
from .symmetry import SpaceGroup

_INTEGRATE_COLS = [
    "H", "K", "L", "IOBS", "SIGMA", "XCAL", "YCAL", "ZCAL", "RLP", "PEAK",
    "CORR", "MAXC", "XOBS", "YOBS", "ZOBS", "ALF0", "BET0", "ALF1", "BET1",
    "PSI", "ISEG",
]


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(formatter_class=argparse.RawTextHelpFormatter,
                         description=__doc__)
        self.add_argument("hkl", help="Unmerged HKL file from XDS.")
        self.add_argument("mtz_out", help="Output mtz file name.")
        self.add_argument("-t", "--file-type", default=None, type=str,
                          help="Override the type of HKL file ('ascii' or "
                               "'integrate'); inferred from the header by "
                               "default.")
        self.add_argument("-s", "--spacegroup", default=None, type=str,
                          help="Override the space group (number or symbol).")
        self.add_argument("-c", "--cell", default=None, nargs=6,
                          metavar=("a", "b", "c", "alpha", "beta", "gamma"),
                          type=float, help="Override the unit cell.")


def _header_lines(file_name: str):
    with open(file_name) as f:
        yield from f


def get_unit_cell(file_name: str) -> Optional[UnitCell]:
    for line in _header_lines(file_name):
        if line.startswith("!UNIT_CELL_CONSTANTS="):
            return UnitCell(*[float(i) for i in line.split()[1:7]])
    return None


def get_space_group(file_name: str) -> Optional[SpaceGroup]:
    for line in _header_lines(file_name):
        if line.startswith("!SPACE_GROUP_NUMBER="):
            return SpaceGroup.from_name(int(line.split()[1]))
    return None


def get_column_names(file_name: str) -> Optional[List[str]]:
    cols = None
    for line in _header_lines(file_name):
        if line.startswith("!NUMBER_OF_ITEMS_IN_EACH_DATA_RECORD="):
            num_cols = int(line.split("=")[1])
            cols = [str(i) for i in range(num_cols)]
        if line.startswith("!ITEM"):
            name = line.split("_", 1)[1].split("=")[0]
            index = int(line.split("=")[1])
            cols[index - 1] = name
        if line.startswith("!END_OF_HEADER"):
            break
    return cols


def get_format_field(file_name: str) -> Optional[str]:
    for line in _header_lines(file_name):
        if line.startswith("!FORMAT="):
            return line.split()[0].split("=")[1]
        if line.startswith("!END_OF_HEADER"):
            break
    return None


def infer_file_type(file_name: str) -> str:
    format_name = get_format_field(file_name)
    if format_name == "XDS_ASCII":
        return "ascii"
    if format_name is None:
        return "integrate"
    raise ValueError(
        f"Could not determine filetype for file_name: {file_name}")


def read_records(file_name: str, names: List[str]) -> dict:
    """The whitespace-separated records of an XDS file, comments dropped,
    as name -> int64 column (every field an integer) or float64 column."""
    with open(file_name) as f:
        fields = [line.split("!", 1)[0].split() for line in f]
    fields = [r for r in fields if r]
    bad = {len(r) for r in fields} - {len(names)}
    if bad:
        raise ValueError(f"{file_name}: records of {sorted(bad)} fields, "
                         f"expected {len(names)}")
    table = np.array(fields, dtype=str).reshape(len(fields), len(names))
    columns = {}
    for j, name in enumerate(names):
        try:
            columns[name] = table[:, j].astype(np.int64)
        except ValueError:
            columns[name] = table[:, j].astype(np.float64)
    return columns


def _read_hkl(file_name, cell, spacegroup, names) -> DataSet:
    if cell is None:
        cell = get_unit_cell(file_name)
    if spacegroup is None:
        spacegroup = get_space_group(file_name)
    ds = DataSet(read_records(file_name, names), cell=cell,
                 spacegroup=spacegroup, mtz_dtypes={})
    for c in ("H", "K", "L"):
        ds[c] = ds[c].astype(np.int32)
        ds.mtz_dtypes[c] = "H"
    for c, t in (("IOBS", "J"), ("SIGMA", "Q")):
        if c in ds.columns:
            ds.mtz_dtypes[c] = t
    return ds


def read_integrate_hkl(file_name, cell=None, spacegroup=None) -> DataSet:
    ds = _read_hkl(file_name, cell, spacegroup, _INTEGRATE_COLS)
    ds["BATCH"] = np.round(ds["ZOBS"]).astype(np.int32)
    ds.mtz_dtypes["BATCH"] = "B"
    return ds


def read_ascii_hkl(file_name, cell=None, spacegroup=None, zkey="ZD") -> DataSet:
    cols = get_column_names(file_name)
    ds = _read_hkl(file_name, cell, spacegroup, cols)
    if zkey in ds.columns:
        ds["BATCH"] = np.round(ds[zkey]).astype(np.int32)
        ds.mtz_dtypes["BATCH"] = "B"
    for c in list(ds.columns):
        if c.startswith("SIGMA"):
            ds.mtz_dtypes[c] = "Q"
        elif c == "IOBS":
            ds.mtz_dtypes[c] = "J"
    return ds


def read_hkl(file_name, cell=None, spacegroup=None, file_type=None) -> DataSet:
    if file_type is None:
        file_type = infer_file_type(file_name)
    if file_type == "integrate":
        return read_integrate_hkl(file_name, cell, spacegroup)
    if file_type == "ascii":
        return read_ascii_hkl(file_name, cell, spacegroup)
    raise ValueError(
        f"file_type, {file_type} not one of 'integrate', 'ascii'.")


def run(parser):
    cell = UnitCell(*parser.cell) if parser.cell else None
    sg = SpaceGroup.from_name(parser.spacegroup) if parser.spacegroup else None
    ds = read_hkl(parser.hkl, cell, sg, parser.file_type)
    write_mtz(ds, parser.mtz_out)


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
