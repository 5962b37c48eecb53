"""Compute CChalf from careless-tpu output.

The port's careless_tpu/stats/cchalf.py: pair the half-dataset outputs on
(H, K, L, repeat), correlate the halves per resolution bin (pearson,
spearman or weighted), CSV and plot; --use-structure-factors switches I to
F.
"""
from ._lib import (BaseParser, GroupBy, bin_by_percentile, cc_funcs, dropna,
                   emit, grouped_result, inner_merge, lineplot, load_concat,
                   pick, resolution_labels, stack_anomalous, table)


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+",
                          help="MTZs containing crossvalidation data")
        self.add_argument("-m", "--method", default="pearson",
                          choices=["pearson", "spearman", "weighted"],
                          help="Correlation method (default pearson).")
        self.add_argument("-b", "--bins", default=10, type=int,
                          help="Number of resolution bins (default 10).")
        self.add_argument("--overall", action="store_true",
                          help="Pool all mtz files into a single calculation.")
        self.add_argument("--use-structure-factors", action="store_true",
                          help="Use F instead of I for the CChalf calculation.")


def halves(mtz, keys):
    """Each half's rows (anomalous files stacked first), their `keys`."""
    out = []
    for h in (0, 1):
        half = mtz.select(mtz["half"] == h)
        if "F(+)" in half.columns:
            half = stack_anomalous(half)
        out.append(pick(half, keys))
    return out


def make_halves_cchalf(mtz):
    half1, half2 = halves(mtz, ["H", "K", "L", "F", "SigF", "I", "SigI",
                                "repeat"])
    out = dropna(inner_merge(half1, half2, ["H", "K", "L", "repeat"]))
    return table({k: out[k] for k in out.columns}, like=mtz)


def by_bin(ds, args, name, values_of, labels):
    """The per-group table of a cross-validation statistic: `values_of(ds,
    groups)` over (file, bin, repeat), or (bin, repeat) with --overall."""
    g = GroupBy(ds, ["bin", "repeat"] if args.overall
                else ["file", "bin", "repeat"])
    cols = grouped_result(ds, g, name, values_of(ds, g), labels)
    keys = ["repeat", "Resolution Range (Å)", "bin", "Spacegroup", name]
    return table({k: cols[k] for k in ([] if args.overall else ["file"])
                  + keys})


def binned(ds, bins):
    labels, edges = bin_by_percentile(ds["dHKL"], bins, ascending=False)
    ds["bin"] = labels
    return resolution_labels(edges)


def run_analysis(args):
    ds = load_concat(args.mtz, transform=make_halves_cchalf)
    labels = binned(ds, args.bins)
    if args.use_structure_factors:
        ds = pick(ds, ["file", "bin", "repeat", "F1", "SigF1", "F2", "SigF2",
                       "Spacegroup"],
                  {"F1": "I1", "F2": "I2", "SigF1": "SigI1",
                   "SigF2": "SigI2"})
    ccfunc = cc_funcs("I1", "I2", "SigI1", "SigI2")[args.method.lower()]
    result = by_bin(ds, args, "CChalf", ccfunc, labels)

    emit(result, args)
    lineplot(result, args, x="bin", y="CChalf", labels=labels, bins=args.bins,
             hue=None if args.overall else "file",
             ylabel=r"$\mathrm{CC_{1/2}}$ " + f"({args.method})")
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
