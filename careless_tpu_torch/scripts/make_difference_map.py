"""Construct weighted time-resolved difference structure factors from two
careless-tpu output mtzs (off/on) plus a phase mtz from refinement.

The port's scripts/make_difference_map:

    python -m careless_tpu_torch.scripts.make_difference_map off.mtz on.mtz \
        phases.mtz [-o difference.mtz] [--positive] [--embed]

DeltaF = Fon - Foff with propagated sigmas on the reflections all three
files hold (in the off file's order), plus the weighting schemes W
(uniform), DH (Hekstra), ML (inverse variance), RNORM (resolution-
normalized) and KDE, and ScaledDeltaF where the phase file has F-model.
--embed opens an IPython shell at the end (IPython must be installed).
"""
from argparse import ArgumentParser as _AP

import numpy as np

from ..io.asu import pack_hkl
from ..stats._lib import dropna, stack_anomalous
from ..xtal import DataSet, read_mtz, write_mtz


class ArgumentParser(_AP):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("off_mtz")
        self.add_argument("on_mtz")
        self.add_argument("phase_mtz")
        self.add_argument("-o", help="output mtz filename",
                          default="difference.mtz")
        self.add_argument("--embed", action="store_true")
        self.add_argument("--positive", action="store_true",
                          help="convert difference structure factors to be "
                               "strictly positive")


def mean_by_resolution(values, d, bins=50):
    """Binned mean of `values` by resolution, evaluated back per reflection
    (rs mean_intensity_by_resolution equivalent)."""
    edges = np.percentile(d, np.linspace(0, 100, bins + 1))
    lab = np.clip(np.searchsorted(edges, d, side="right") - 1, 0, bins - 1)
    sums = np.bincount(lab, weights=values, minlength=bins)
    counts = np.maximum(np.bincount(lab, minlength=bins), 1)
    return (sums / counts)[lab]


def maybe_stack(ds):
    if any(c.endswith("(+)") for c in ds.columns):
        stacked = stack_anomalous(ds)
        stacked.mtz_dtypes = dict(ds.mtz_dtypes)
        return stacked
    return ds


def common_rows(*tables):
    """Each table's row of every (H, K, L) that all hold, in the first
    table's order without repeats (pandas' Index.intersection on H, K, L,
    then .loc, for tables whose indices are unique)."""
    keys = [pack_hkl(t.get_hkls()) for t in tables]
    _, first = np.unique(keys[0], return_index=True)
    first = np.sort(first)
    held = np.ones(len(first), bool)
    for k in keys[1:]:
        held &= np.isin(keys[0][first], k)
    want = keys[0][first[held]]
    rows = []
    for k in keys:
        order = np.argsort(k, kind="stable")
        rows.append(order[np.searchsorted(k[order], want)])
    return rows


def run(args):
    """Writes and returns the difference DataSet."""
    phases = maybe_stack(dropna(read_mtz(args.phase_mtz)))
    off = maybe_stack(read_mtz(args.off_mtz))
    on = maybe_stack(read_mtz(args.on_mtz))

    phase_key = "PHIF-model"
    if phase_key not in phases.columns:
        p_cols = [c for c in phases.columns
                  if phases.mtz_dtypes.get(c) == "P"]
        if not p_cols:
            raise SystemExit("no phase column found in phase mtz")
        phase_key = p_cols[0]

    r_off, r_on, r_ph = common_rows(off, on, phases)
    hkl = off.get_hkls()[r_off]
    output = DataSet({
        "H": hkl[:, 0].astype(np.int32), "K": hkl[:, 1].astype(np.int32),
        "L": hkl[:, 2].astype(np.int32),
        "Foff": off["F"][r_off].astype(np.float32),
        "SigFoff": off["SigF"][r_off].astype(np.float32),
        "Fon": on["F"][r_on].astype(np.float32),
        "SigFon": on["SigF"][r_on].astype(np.float32),
        "PhiFoff": phases[phase_key][r_ph].astype(np.float32),
    }, cell=phases.cell, spacegroup=phases.spacegroup)
    if "F-model" in phases.columns:
        output["F-model"] = phases["F-model"][r_ph].astype(np.float32)

    output["DeltaF"] = output["Fon"] - output["Foff"]
    output["SigDeltaF"] = np.sqrt(output["SigFon"] ** 2
                                  + output["SigFoff"] ** 2)

    if args.positive:
        cmplx = output["DeltaF"].astype(np.float64) * np.exp(
            1j * np.deg2rad(output["PhiFoff"].astype(np.float64)))
        output["DeltaF"] = np.abs(cmplx).astype(np.float32)
        output["PhiDeltaF"] = np.rad2deg(np.angle(cmplx)).astype(np.float32)

    sig2 = output["SigDeltaF"].astype(np.float64) ** 2
    dF2 = output["DeltaF"].astype(np.float64) ** 2
    output["W"] = (1.0 / (1 + sig2 / sig2.mean())).astype(np.float32)
    output["DH"] = (1.0 / (1 + sig2 / sig2.mean()
                           + 0.05 * dF2 / dF2.mean())).astype(np.float32)
    output["ML"] = (1.0 / np.maximum(sig2, 1e-20)).astype(np.float32)

    d = output.cell.compute_d(output.get_hkls()).astype(
        np.float32).astype(np.float64)
    foff = output["Foff"].astype(np.float64)
    fon = output["Fon"].astype(np.float64)
    mu_off = mean_by_resolution(foff, d)
    sd_off = np.sqrt(np.maximum(mean_by_resolution((foff - mu_off) ** 2, d),
                                1e-20))
    mu_on = mean_by_resolution(fon, d)
    sd_on = np.sqrt(np.maximum(mean_by_resolution((fon - mu_on) ** 2, d),
                               1e-20))
    from scipy.stats import gaussian_kde, norm
    output["RNORM"] = (norm(mu_on, sd_on).pdf(fon)
                       * norm(mu_off, sd_off).pdf(foff)).astype(np.float32)

    X = np.stack([foff, fon, d])
    X = (X - X.mean(1)[:, None]) / X.std(1)[:, None]
    try:
        output["KDE"] = gaussian_kde(X)(X).astype(np.float32)
    except np.linalg.LinAlgError:
        # degenerate (e.g. identical on/off) data: uniform weights
        output["KDE"] = np.ones(len(output), np.float32)

    if "F-model" in output.columns:
        fmodel = output["F-model"].astype(np.float64)
        output["ScaledDeltaF"] = (
            output["DeltaF"].astype(np.float64)
            * mean_by_resolution(fmodel, d) / mean_by_resolution(foff, d)
        ).astype(np.float32)

    output.mtz_dtypes.update({
        "H": "H", "K": "H", "L": "H", "Foff": "F", "SigFoff": "Q", "Fon": "F",
        "SigFon": "Q", "PhiFoff": "P", "F-model": "F", "DeltaF": "F",
        "SigDeltaF": "Q", "PhiDeltaF": "P", "W": "W", "DH": "W", "ML": "W",
        "RNORM": "W", "KDE": "W", "ScaledDeltaF": "F"})
    write_mtz(output, args.o)
    print(f"wrote {args.o} ({len(output)} reflections)")

    if args.embed:
        try:
            from IPython import embed
        except ImportError as e:
            raise ImportError(f"--embed needs IPython: {e}") from e
        embed(colors="Linux")
    return output


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
