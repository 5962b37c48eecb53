"""Compute CCanom from careless-tpu output.

The port's careless_tpu/stats/ccanom.py: Danom = F(+) - F(-) per half
(where N(+) > 0 and N(-) > 0), correlated between halves per resolution
bin.
"""
import numpy as np

from ._lib import (BaseParser, cc_funcs, emit, inner_merge, lineplot,
                   load_concat, table)
from .cchalf import binned, by_bin


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+",
                          help="MTZs containing crossvalidation data")
        self.add_argument("-m", "--method", default="weighted",
                          choices=["weighted", "pearson", "spearman"],
                          help="Correlation method (default weighted, "
                               "consistent with XDS).")
        self.add_argument("-b", "--bins", default=10, type=int,
                          help="Number of resolution bins (default 10).")
        self.add_argument("--overall", action="store_true",
                          help="Pool all mtz files into a single calculation.")


def make_halves_ccanom(mtz):
    mtz = mtz.select((mtz["N(+)"] > 0) & (mtz["N(-)"] > 0))
    half = []
    for h in (0, 1):
        d = mtz.select(mtz["half"] == h)
        half.append(table({
            "H": d["H"], "K": d["K"], "L": d["L"],
            "Danom": d["F(+)"] - d["F(-)"],
            "SigDanom": np.sqrt(np.square(d["SigF(+)"])
                                + np.square(d["SigF(-)"])),
            "repeat": d["repeat"]}))
    out = inner_merge(half[0], half[1], ["H", "K", "L", "repeat"])
    return table({k: out[k] for k in out.columns}, like=mtz)


def run_analysis(args):
    ds = load_concat(args.mtz, transform=make_halves_ccanom)
    labels = binned(ds, args.bins)
    ccfunc = cc_funcs("Danom1", "Danom2", "SigDanom1",
                      "SigDanom2")[args.method.lower()]
    result = by_bin(ds, args, "CCanom", ccfunc, labels)

    emit(result, args)
    lineplot(result, args, x="bin", y="CCanom", labels=labels, bins=args.bins,
             hue=None if args.overall else "file",
             ylabel=r"$\mathrm{CC_{anom}}$ " + f"({args.method})")
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
