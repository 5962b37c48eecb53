"""Compute mean I/sigI per resolution bin from careless-tpu output.

The port's careless_tpu/stats/isigi.py.
"""
import os

import numpy as np

from ..io.formatter import get_first_key_of_dtype
from ._lib import (BaseParser, GroupBy, emit, grouped_result, lineplot,
                   load_concat, table)
from .cchalf import binned


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+", help="Careless output MTZs")
        self.add_argument("-b", "--bins", default=20, type=int,
                          help="Number of resolution bins (default 20).")
        self.add_argument("--intensity-key", dest="I_col", default=None,
                          type=str, help="Intensity key")
        self.add_argument("--uncertainty-key", dest="sigI_col", default=None,
                          type=str, help="Sigma(Intensity) key")
        self.add_argument("--log", action="store_true",
                          help="Logarithmic y-axis.")
        self.add_argument("--overall", action="store_true",
                          help="Pool all mtz files into a single calculation.")


def run_analysis(args):
    ds = load_concat(args.mtz)
    ds["file"] = np.array([m if len(m) < 50 else os.path.basename(m)
                           for m in ds["file"].tolist()])
    labels = binned(ds, args.bins)
    ikey = args.I_col or get_first_key_of_dtype(ds, "J") or "I"
    sigkey = args.sigI_col or get_first_key_of_dtype(ds, "Q") or "SigI"

    g = GroupBy(ds, ["bin"] if args.overall else ["file", "bin"])
    ratio = g.values(ds[ikey] / ds[sigkey])
    # each group's mean in the column's type, as pandas' Series.mean
    means = np.array([np.mean(ratio[s:e]) for s, e in g.segments()],
                     dtype=ratio.dtype)
    cols = grouped_result(ds, g, "I/sigI", means, labels)
    keys = ["Resolution Range (Å)", "bin", "Spacegroup", "I/sigI"]
    result = table({k: cols[k] for k in ([] if args.overall else ["file"])
                    + keys})

    emit(result, args)
    lineplot(result, args, x="bin", y="I/sigI", labels=labels,
             bins=args.bins, hue=None if args.overall else "file",
             ylabel=r"$\mathrm{I/\sigma(I)}$", log=args.log)
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
