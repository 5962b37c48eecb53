"""Analyze fitting for careless-tpu output using correlation coefficients per
resolution bin (work/test split).

The port's scripts/plot_predictions:

    python -m careless_tpu_torch.scripts.plot_predictions \
        x_predictions_0.mtz [...] [-n 20] [-d dmin] [--image out.png]

The table (`table(args)`): per file, scipy's pearsonr and spearmanr of
the two keys per (resolution bin, Work/Test set) and overall per set (bin
= n), in long form with the columns bin, File, Set, Method and
"Correlation Coefficient". The plot (matplotlib) draws each method and set
against the bin, one figure per file, or one over all files with
--as-repeats.
"""
from argparse import ArgumentParser as _AP

import numpy as np

from ..stats._lib import GroupBy, draw_lines, table as make_table
from ..xtal import DataSet, read_mtz


class ArgumentParser(_AP):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("-n", "--resolution-bins", dest="resolution_bins",
                          type=int, default=20)
        self.add_argument("-r", "--as-repeats", action="store_true",
                          default=False,
                          help="Treat files as repeats and use them to "
                               "calculate confidence intervals")
        self.add_argument("-d", "--dmin", dest="dmin", type=float,
                          default=None)
        self.add_argument("-k", "--cc-keys", dest="cc_keys", type=str,
                          default="Iobs,Ipred",
                          help="Comma separated list of two keys to "
                               "correlate.")
        self.add_argument("--image", type=str, default=None,
                          help="Save the plot to this file instead of "
                               "showing it.")
        self.add_argument("predictions_mtz_file", nargs="+")


def d_hkl(ds):
    return ds.cell.compute_d(ds.get_hkls()).astype(np.float32)


def bins_of(args):
    """The resolution bin edges over all files, and their labels (the last
    one the whole range)."""
    dHKL = np.concatenate([d_hkl(read_mtz(f)).astype(np.float64)
                           for f in args.predictions_mtz_file])
    if args.dmin is not None:
        dHKL = dHKL[dHKL >= args.dmin]
    nbins = args.resolution_bins
    edges = np.percentile(dHKL, np.linspace(0.0, 100.0, nbins + 1))
    fmt = "0.2f"
    labels = [f"{i:{fmt}}-{j:{fmt}}" for i, j in zip(edges[:-1], edges[1:])]
    labels.append(f"{edges[0]:{fmt}}-{edges[-1]:{fmt}}")
    return edges, labels


def table(args):
    """The long table of correlation coefficients (the reference's `data`
    after its melt)."""
    from scipy.stats import pearsonr, spearmanr

    key_1, key_2 = args.cc_keys.split(",")
    nbins = args.resolution_bins
    edges, _ = bins_of(args)
    parts = {"bin": [], "Set": [], "Pearson": [], "Spearman": [],
             "File": []}
    for file_name in args.predictions_mtz_file:
        ds = read_mtz(file_name)
        ds["dHKL"] = d_hkl(ds)
        if args.dmin is not None:
            ds = ds.select(ds["dHKL"] >= args.dmin)
        ds["bin"] = np.maximum(
            np.digitize(ds["dHKL"], bins=edges, right=True) - 1, 0)
        ds["Set"] = np.array(["Work", "Test"])[ds["test"]]
        for keys, overall in ((["bin", "Set"], False), (["Set"], True)):
            g = GroupBy(ds, keys)
            x, y = g.values(ds[key_1]), g.values(ds[key_2])
            for i, (s, e) in enumerate(g.segments()):
                parts["bin"].append(nbins if overall
                                    else g.key_values["bin"][i])
                parts["Set"].append(g.key_values["Set"][i])
                parts["Pearson"].append(pearsonr(x[s:e], y[s:e])[0])
                parts["Spearman"].append(spearmanr(x[s:e], y[s:e])[0])
                parts["File"].append(file_name)
    n = len(parts["bin"])
    return make_table({
        "bin": np.tile(np.array(parts["bin"], np.int64), 2),
        "File": np.tile(np.array(parts["File"]), 2),
        "Set": np.tile(np.array(parts["Set"]), 2),
        "Method": np.repeat(np.array(["Pearson", "Spearman"]), n),
        "Correlation Coefficient": np.concatenate(
            [np.array(parts["Pearson"], np.float64),
             np.array(parts["Spearman"], np.float64)])})


def plot(args, data: DataSet):
    """One figure per file, or one over all with --as-repeats; saved to
    --image (the last figure) or shown."""
    import matplotlib
    if args.image:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nbins = args.resolution_bins
    _, labels = bins_of(args)

    def figure(df, title=None):
        plt.figure()
        draw_lines(plt.gca(), df, "bin", "Correlation Coefficient",
                   hue="Method", style="Set")
        plt.title(title)
        plt.xlabel("Resolution Range ($\\AA$)")
        plt.xticks(range(nbins + 1), labels, rotation=45, ha="right",
                   rotation_mode="anchor")
        plt.ylim([0.0, 1.0])
        plt.tight_layout()

    if args.as_repeats:
        figure(data)
    else:
        for name in sorted(set(data["File"].tolist())):
            figure(data.select(data["File"] == name), title=name)
    if args.image:
        plt.savefig(args.image)
    else:
        plt.show()


def run(args):
    """Computes, plots and returns the table."""
    data = table(args)
    plot(args, data)
    return data


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
