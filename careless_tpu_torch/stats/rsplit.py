"""Compute Rsplit from careless-tpu output.

The port's careless_tpu/stats/rsplit.py: Rsplit = sqrt(2) * min_k
sum|x - k y| / sum(x + k y) by scipy's minimize per resolution bin.
"""
import numpy as np
from scipy.optimize import minimize

from ._lib import (BaseParser, dropna, emit, inner_merge, lineplot,
                   load_concat, table)
from .cchalf import binned, by_bin, halves


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+",
                          help="MTZs containing crossvalidation data")
        self.add_argument("-b", "--bins", default=10, type=int,
                          help="Number of resolution bins (default 10).")
        self.add_argument("--overall", action="store_true",
                          help="Pool all mtz files into a single calculation.")


def rsplit(x, y):
    """Rsplit of one group's F1 and F2 (f64, in the table's row order, so
    that the optimiser takes the JAX tool's path)."""

    def rfunc(k):
        return np.sum(np.abs(x - k * y)) / np.sum(x + k * y)

    p = minimize(rfunc, 1.0)
    return np.sqrt(2) * p.fun


def rsplit_by_group(ds, g):
    x, y = g.values(ds["F1"], np.float64), g.values(ds["F2"], np.float64)
    return np.array([rsplit(np.ascontiguousarray(x[s:e]),
                            np.ascontiguousarray(y[s:e]))
                     for s, e in g.segments()], np.float64)


def make_halves_rsplit(mtz):
    half1, half2 = halves(mtz, ["H", "K", "L", "F", "SigF", "repeat"])
    out = dropna(inner_merge(half1, half2, ["H", "K", "L", "repeat"]))
    return table({k: out[k] for k in out.columns}, like=mtz)


def run_analysis(args):
    ds = load_concat(args.mtz, transform=make_halves_rsplit)
    labels = binned(ds, args.bins)
    result = by_bin(ds, args, "Rsplit", rsplit_by_group, labels)

    emit(result, args)
    lineplot(result, args, x="bin", y="Rsplit", labels=labels,
             bins=args.bins, hue=None if args.overall else "file",
             ylabel=r"$R_{\mathrm{split}}$")
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
