"""Compute CCpred from careless-tpu output.

The port's careless_tpu/stats/ccpred.py: CC(Iobs, Ipred) from
*_predictions_*.mtz grouped by (file, bin, test), giving train and test
curves per resolution bin.
"""
import numpy as np

from ._lib import (BaseParser, GroupBy, cc_funcs, emit, grouped_result,
                   lineplot, load_concat, table)
from .cchalf import binned


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+",
                          help="MTZ(s) containing prediction data")
        self.add_argument("-m", "--method", default="weighted",
                          choices=["weighted", "pearson", "spearman"],
                          help="Correlation method (default weighted).")
        self.add_argument("-b", "--bins", default=10, type=int,
                          help="Number of resolution bins (default 10).")
        self.add_argument("--overall", action="store_true",
                          help="Pool all mtz files into a single calculation.")


def run_analysis(args):
    ds = load_concat(args.mtz)
    labels = binned(ds, args.bins)
    g = GroupBy(ds, ["bin", "test"] if args.overall
                else ["file", "bin", "test"])
    ccfunc = cc_funcs("Iobs", "Ipred", "SigIobs")[args.method.lower()]
    cols = grouped_result(ds, g, "CCpred", ccfunc(ds, g), labels)
    cols["bin"] = cols["bin"].astype(np.int32)
    cols["test"] = np.array(["Train", "Test"])[cols["test"]]
    keys = ["Resolution Range (Å)", "bin", "test", "Spacegroup", "CCpred"]
    result = table({k: cols[k] for k in ([] if args.overall else ["file"])
                    + keys})

    emit(result, args)
    lineplot(result, args, x="bin", y="CCpred", labels=labels, bins=args.bins,
             hue=None if args.overall else "file", style="test",
             ylabel=r"$\mathrm{CC_{pred}}$ " + f"({args.method})")
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
