"""Estimate the Wilson b-factor from unmerged data.

The port's careless_tpu/stats/prior_b.py: a Wilson-plot linear regression
of log<I> against 1/d^2 per resolution bin, with an automatic resolution
cutoff from binned I/sigI; B = -2 * slope.
"""
import argparse

import numpy as np
from scipy.stats import linregress

from ..io.formatter import get_first_key_of_dtype
from ._lib import bin_by_percentile


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(formatter_class=argparse.RawTextHelpFormatter,
                         description=__doc__)
        self.add_argument("input", nargs="+",
                          help="Unmerged reflection file(s), MTZ or CrystFEL "
                               ".stream")
        self.add_argument("-i", "--intensity-key", type=str, default=None)
        self.add_argument("-s", "--sigma-key", type=str, default=None)
        self.add_argument("-b", "--bins", type=int, default=20,
                          help="Number of bins (default 20).")
        group = self.add_mutually_exclusive_group()
        group.add_argument("-c", "--isigi-cutoff", type=float, default=1.5,
                           help="Estimate a resolution cutoff from binned "
                                "signal to noise (default 1.5).")
        group.add_argument("-d", "--dmin", type=float, default=None,
                           help="Explicit resolution cutoff in Å.")
        self.add_argument("-x", "--dmax", type=float, default=np.inf)
        self.add_argument("--plot", action="store_true")


def binned_means(dHKL, bins, *values):
    """Each ascending percentile bin's mean of each value array, over the
    bins that hold rows (pandas' groupby("bin").mean())."""
    labels, _ = bin_by_percentile(dHKL, bins, ascending=True)
    counts = np.bincount(labels)
    held = counts > 0
    return [np.bincount(labels, weights=v)[held] / counts[held]
            for v in values]


def _truncate_data(dHKL, I, SigI, bins=20, isigi_cutoff=None, dmin=None):
    if isigi_cutoff is None and dmin is None:
        return dHKL, I, SigI
    if dmin is not None:
        idx = dHKL >= dmin
        return dHKL[idx], I[idx], SigI[idx]
    d_mean, isigi = binned_means(dHKL, bins, dHKL, I / SigI)
    kept = d_mean[isigi >= isigi_cutoff]
    dmin = kept.min() if len(kept) else np.nan
    return _truncate_data(dHKL, I, SigI, bins, None, dmin)


def estimate_b(dHKL, I, SigI, bins=20, isigi_cutoff=None, dmin=None):
    """Wilson b-factor fit: linregress of the binned log<I> on <1/d^2>."""
    dHKL, I, SigI = _truncate_data(dHKL, I, SigI, bins, isigi_cutoff, dmin)
    mean_i, x = binned_means(dHKL, bins, I, np.reciprocal(np.square(dHKL)))
    y = np.log(mean_i)
    result = linregress(x, y)
    result.x = x
    result.y = y
    return result


def read_inputs(paths):
    """The files' rows in turn with a file_id column, in the first's
    context."""
    from ..xtal import concat_datasets, read_mtz
    from ..xtal.stream import read_crystfel

    frames = []
    for i, file in enumerate(paths):
        if file.endswith(".mtz"):
            ds = read_mtz(file)
        elif file.endswith(".stream"):
            ds = read_crystfel(file)
        else:
            raise ValueError(f"unsupported input {file}")
        ds["file_id"] = np.full(len(ds), i)
        frames.append(ds)
    return concat_datasets(frames)


def run_analysis(parser):
    """Prints and returns the fit (scipy's LinregressResult, with the
    binned x and y)."""
    cat = read_inputs(parser.input)
    ikey = parser.intensity_key or get_first_key_of_dtype(cat, "J") or "I"
    sigkey = parser.sigma_key
    if sigkey is None:
        for prefix in ("Sig", "SIG"):
            if prefix + ikey in cat.columns:
                sigkey = prefix + ikey
    sigkey = sigkey or "SigI"

    cat.compute_dHKL(inplace=True)
    dHKL = cat["dHKL"].astype(np.float64)
    I = cat[ikey].astype(np.float64)
    SigI = cat[sigkey].astype(np.float64)
    fit = estimate_b(dHKL, I, SigI, parser.bins, parser.isigi_cutoff,
                     parser.dmin)

    title = (f"Estimated Wilson b-factor: {-2.0 * fit.slope:0.2f} "
             f"± {2.0 * fit.stderr:0.2f}")
    if parser.plot:
        import matplotlib.pyplot as plt
        plt.scatter(fit.x, fit.y, color="k")
        xs = np.array([np.min(fit.x), np.max(fit.x)])
        plt.plot(xs, fit.intercept + fit.slope * xs, color="k")
        plt.xlabel(r"$1 / d_{HKL}^2\ (Å^{-2})$")
        plt.ylabel(r"$\log \langle I \rangle$")
        plt.title(title)
        plt.show()
    print(title)
    return fit


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
