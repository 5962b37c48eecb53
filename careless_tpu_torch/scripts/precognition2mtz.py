"""Convert a single sweep/timepoint from Precognition .ii/.inp format (Laue)
to a single MTZ.

The port's scripts/precognition2mtz:

    python -m careless_tpu_torch.scripts.precognition2mtz \
        --ii-files a.ii b.ii --inp-files a.inp b.inp [--logs x.log] -o out.mtz

A .ii file is whitespace-delimited: H K L Multiplicity X Y Resolution
Wavelength I SigI (`#` starts a comment; a missing trailing field or an NA
token such as `nan` is NaN). The .inp carries the cell and the space
group on its "Crystal" line; the cell written is the files' average.
BATCH is the file's position unless BioCARS logs are given (tab-separated
after 18 header lines; BATCH is the row whose `file` is the .inp's name).
Each file keeps one row per (X, Y) spot, sorted by (X, Y), each column's
first non-NaN value (pandas' groupby(["X", "Y"]).first()).

WARNING: defaults to lexicographic-order BATCH values, like the reference.
"""
import argparse
import csv

import numpy as np

from ..stats._lib import GroupBy
from ..xtal import DataSet, SpaceGroup, UnitCell, concat_datasets, write_mtz

II_COLS = ["H", "K", "L", "Multiplicity", "X", "Y", "Resolution",
           "Wavelength", "I", "SigI"]
# the tokens pandas' read_csv reads as NaN by default
NA_TOKENS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
             "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
             "None", "n/a", "nan", "null"}


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("--ii-files", nargs="+", required=True,
                          help="Precognition .ii integration files")
        self.add_argument("--inp-files", nargs="+", required=True,
                          help="Matching .inp metadata files")
        self.add_argument("--logs", nargs="+", default=None,
                          help="Optional BioCARS log files for BATCH "
                               "assignment")
        self.add_argument("-g", "--spacegroup", default=None,
                          help="Override the spacegroup (number or symbol)")
        self.add_argument("-o", "--out", default="precognition.mtz")


def _column(tokens):
    """A column of tokens as pandas types it: int64 when every token is an
    integer, else float64 (NA tokens NaN)."""
    try:
        return np.array([int(t) for t in tokens], np.int64)
    except ValueError:
        return np.array([np.nan if t in NA_TOKENS else float(t)
                         for t in tokens], np.float64)


def read_ii(path) -> dict:
    rows = []
    with open(path) as f:
        for line in f:
            fields = line.split("#", 1)[0].split()
            if fields:
                rows.append(fields + [""] * (len(II_COLS) - len(fields)))
    return {k: _column([r[j] for r in rows]) for j, k in enumerate(II_COLS)}


def parse_logs(logs):
    """The `file` entry of each row of the logs, in turn."""
    files = []
    for log in logs:
        with open(log) as f:
            for _ in range(18):
                f.readline()
            reader = csv.reader(f, delimiter="\t")
            header = next(reader)
            at = header.index("file")
            files += [row[at] for row in reader if row]
    return np.array(files, dtype=object)


def first_by_spot(cols: dict) -> dict:
    """One row per (X, Y), sorted by (X, Y), the keys first and each other
    column's first non-NaN value (groupby(["X", "Y"],
    as_index=False).first())."""
    ds = DataSet(cols)
    g = GroupBy(ds, ["X", "Y"])
    out = dict(g.key_values)
    out.update((k, g.first(v)) for k, v in cols.items() if k not in out)
    return out


def run(args):
    """Writes and returns the DataSet."""
    log_files = parse_logs(args.logs) if args.logs else None
    frames = []
    cell = np.zeros(6)
    sg_number = None
    for file_number, (ii_fn, inp_fn) in enumerate(zip(args.ii_files,
                                                      args.inp_files)):
        cols = read_ii(ii_fn)
        with open(inp_fn) as f:
            for line in f:
                if "Crystal" in line:
                    cell += np.array(list(map(float, line.split()[1:7]))
                                     ) / len(args.ii_files)
                    if args.spacegroup is None:
                        sg_number = int(line.split()[7])
        if log_files is None:
            batch = file_number
        else:
            entry = np.flatnonzero(log_files == inp_fn[:-4])
            if len(entry) != 1:
                raise ValueError(f"{len(entry)} log rows name {inp_fn[:-4]}, "
                                 "expected one")
            batch = entry[0]
        cols["BATCH"] = np.full(len(cols["H"]), batch, np.int64)
        frames.append(DataSet(first_by_spot(cols)))

    data = concat_datasets(frames)
    sg = (SpaceGroup.from_name(args.spacegroup) if args.spacegroup
          else SpaceGroup.from_name(sg_number))
    ds = DataSet({k: (data[k].astype(np.int32) if k in ("H", "K", "L")
                      else data[k])
                  for k in data.columns
                  if k not in ("Multiplicity", "Resolution")},
                 cell=UnitCell(*cell), spacegroup=sg,
                 mtz_dtypes={"H": "H", "K": "H", "L": "H", "I": "J",
                             "SigI": "Q", "BATCH": "B", "X": "R", "Y": "R",
                             "Wavelength": "R"})
    write_mtz(ds, args.out)
    print(f"wrote {args.out} ({len(ds)} reflections)")
    return ds


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
