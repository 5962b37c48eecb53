"""Rescale careless-tpu output to match a given Wilson b-factor.

The port's careless_tpu/stats/rescale.py: F and SigF scaled by
exp(-B / 4d^2), I and SigI by exp(-B / 2d^2), with or without (+/-).
"""
import argparse

import numpy as np

from ..xtal import read_mtz, write_mtz


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(formatter_class=argparse.RawTextHelpFormatter,
                         description=__doc__)
        self.add_argument("mtz_in", help="Merged MTZ to rescale")
        self.add_argument("mtz_out", help="Where to write the rescaled MTZ")
        self.add_argument("-b", "--wilson-b", type=float, required=True,
                          help="Wilson B-factor (Å²) to impose on the output")


def run_analysis(parser):
    """Writes and returns the rescaled DataSet."""
    ds = read_mtz(parser.mtz_in)
    dHKL = ds.cell.compute_d(ds.get_hkls()).astype(np.float32)
    id2 = np.reciprocal(np.square(dHKL))
    B = parser.wilson_b
    f_factor = np.exp(-0.25 * B * id2)
    i_factor = np.exp(-0.5 * B * id2)
    for col in ds.columns:
        root = col.replace("(+)", "").replace("(-)", "")
        if root in ("F", "SigF"):
            ds[col] = ds[col] * f_factor
        elif root in ("I", "SigI"):
            ds[col] = ds[col] * i_factor
    write_mtz(ds, parser.mtz_out)
    return ds


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
