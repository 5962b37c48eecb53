"""Compute completeness from careless-tpu output.

The port's careless_tpu/stats/completeness.py (rs.stats.compute_completeness):
the fraction of the reciprocal ASU observed per resolution bin, with an
overall row first. Expected reflections come from the port's own ASU
generator.
"""
import numpy as np

from ..io.asu import pack_hkl
from ._lib import (BaseParser, bin_by_percentile, emit, pyplot,
                   read_careless_mtz, table)


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", help="MTZ containing merged data")
        self.add_argument("-b", "--bins", default=10, type=int,
                          help="Number of resolution bins (default 10).")


def compute_completeness(ds, bins: int = 10):
    """Observed / expected unique reflections per resolution bin, the
    overall row first."""
    anomalous = "F(+)" in ds.columns
    d = ds.cell.compute_d(ds.get_hkls()).astype(np.float32).astype(np.float64)
    _, edges = bin_by_percentile(d, bins, ascending=False)

    sg, cell = ds.spacegroup, ds.cell
    asu = sg.generate_reciprocal_asu(cell, float(d.min()), anomalous=False)
    asu_d = cell.compute_d(asu)
    centric = sg.is_centric(asu)

    hkl_plus, _ = sg.map_to_asu(ds.get_hkls())
    asu_keys = pack_hkl(asu)
    observed = np.isin(asu_keys, pack_hkl(hkl_plus))
    if anomalous:
        minus = pack_hkl(hkl_plus[~np.isnan(ds["F(-)"])])
        observed_anom = observed & np.isin(asu_keys, minus) & ~centric

    ranges = list(zip(edges[:-1], edges[1:])) + [(edges[0], edges[-1])]
    names = [f"{e1:0.2f} - {e2:0.2f}" for e1, e2 in ranges[:-1]] + ["overall"]
    rows = {"Resolution Range (Å)": [], "all": []}
    if anomalous:
        rows["anomalous"] = []
    for (e1, e2), name in zip(ranges, names):
        lo, hi = min(e1, e2), max(e1, e2)
        sel = ((asu_d >= lo - 1e-9) & (asu_d <= hi + 1e-9)
               if name != "overall" else np.ones(len(asu), bool))
        rows["Resolution Range (Å)"].append(name)
        rows["all"].append(observed[sel].sum() / max(sel.sum(), 1))
        if anomalous:
            rows["anomalous"].append(observed_anom[sel].sum()
                                     / max((sel & ~centric).sum(), 1))
    # overall first (the reference rolls it to the front)
    return table({k: np.array(v[-1:] + v[:-1]) for k, v in rows.items()})


def run_analysis(args):
    ds = read_careless_mtz(args.mtz)
    results = compute_completeness(ds, bins=args.bins)

    emit(results, args)
    if args.image is not None or args.show:
        plt = pyplot(args)
        xlabel = "Resolution Range (Å)"
        names = results[xlabel].tolist()
        plt.figure(figsize=(args.width, args.height))
        cmap = plt.get_cmap("Dark2")
        for i, k in enumerate(c for c in results.columns if c != xlabel):
            plt.plot(range(len(names)), results[k], color=cmap(i), label=k)
        plt.xticks(range(len(names)), names, rotation=45,
                   rotation_mode="anchor", ha="right")
        plt.xlabel(xlabel)
        plt.legend(title="")
        plt.ylabel("Completeness")
        plt.grid(which="both", axis="both", ls="dashdot")
        if args.ylim is not None:
            plt.ylim(args.ylim)
        plt.tight_layout()
        if args.image is not None:
            plt.savefig(args.image)
        if args.show:
            plt.show()
        plt.close("all")
    return results


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
