"""Compute per-image CCpred from careless-tpu output.

The port's careless_tpu/stats/image_cc.py: CC(Iobs, Ipred) grouped per
image (BATCH) per file.
"""
from ._lib import (BaseParser, GroupBy, cc_funcs, emit, lineplot, load_concat,
                   table)


class ArgumentParser(BaseParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("mtz", nargs="+",
                          help="MTZ(s) containing prediction data")
        self.add_argument("-m", "--method", default="weighted",
                          choices=["weighted", "pearson", "spearman"],
                          help="Correlation method (default weighted).")


def image_ccs(ds, method, image_key):
    """CCpred of each (file, image) group: the columns file, file_id,
    asu_id, the image key and CCpred."""
    g = GroupBy(ds, ["file", image_key])
    cc = cc_funcs("Iobs", "Ipred", "SigIobs")[method.lower()](ds, g)
    return table({"file": g.key_values["file"],
                  "file_id": g.first(ds["file_id"]),
                  "asu_id": g.first(ds["asu_id"]),
                  image_key: g.key_values[image_key], "CCpred": cc})


def run_analysis(args):
    ds = load_concat(args.mtz)
    by_asu = GroupBy(ds, ["asu_id"])
    first = by_asu.broadcast(by_asu.min(ds["image_id"]), len(ds))
    ds["BATCH"] = ds["image_id"] - first + 1
    result = image_ccs(ds, args.method, "BATCH")

    emit(result, args)
    lineplot(result, args, x="BATCH", y="CCpred", hue="file",
             ylabel=r"$\mathrm{CC_{pred}}$ " + f"({args.method})")
    return result


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
