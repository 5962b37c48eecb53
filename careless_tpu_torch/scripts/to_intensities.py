"""Add intensity columns to a careless-tpu output mtz (F -> I with truncated
normal moments).

The port's scripts/to_intensities:

    python -m careless_tpu_torch.scripts.to_intensities [--anomalous] in.mtz out.mtz

I = F^2 + SigF^2 in f32, and SigI = sqrt(E[F^4] - E[F^2]^2) from the
truncated-normal posterior columns (loc, scale, low, high) through the
port's TruncatedNormal (moment_4, mean, variance), computed on the card
unless the caller asks for the CPU. With --anomalous the (+)/(-) columns
are stacked first and unstacked after, the anomalous columns first.
"""
from argparse import ArgumentParser as _AP

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.manager import _unstack_anomalous
from ..ops.distributions import TruncatedNormal
from ..stats._lib import dropna, pick, stack_anomalous
from ..xtal import write_mtz
from ..xtal.mtz import read_mtz

ANOM_KEY_ORDER = ["F(+)", "SigF(+)", "F(-)", "SigF(-)", "I(+)", "SigI(+)",
                  "I(-)", "SigI(-)", "N(+)", "N(-)"]


class ArgumentParser(_AP):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("--anomalous", action="store_true")
        self.add_argument("mtz")
        self.add_argument("out")


def sigma_i(loc, scale, low, high, device: DeviceLike = None) -> np.ndarray:
    """SigI of each reflection from its truncated-normal posterior (f32),
    computed on `device` (the card when None)."""
    dev = resolve_device(device)
    q = TruncatedNormal(*(torch.as_tensor(np.asarray(v, np.float32),
                                          device=dev)
                          for v in (loc, scale, low, high)))
    f4 = q.moment_4()
    f2 = torch.square(q.mean()) + q.variance()
    sig = torch.sqrt(torch.clamp(f4 - f2 * f2, min=0.0))
    return sig.cpu().numpy().astype(np.float32)


def run(args, device: DeviceLike = None):
    """Writes and returns the DataSet with I and SigI."""
    orig = read_mtz(args.mtz)
    ds = orig
    if args.anomalous:
        ds = dropna(stack_anomalous(orig))
        ds.mtz_dtypes = dict(orig.mtz_dtypes)
    ds["I"] = ds["F"] * ds["F"] + ds["SigF"] * ds["SigF"]
    ds["SigI"] = sigma_i(ds["loc"], ds["scale"], ds["low"], ds["high"],
                         device)
    ds.mtz_dtypes.update({"I": "J", "SigI": "Q"})

    if args.anomalous:
        ds = _unstack_anomalous(ds, orig)
        keys = ([k for k in ANOM_KEY_ORDER if k in ds.columns]
                + [k for k in ds.columns if k not in ANOM_KEY_ORDER])
        ds = pick(ds, keys)
    write_mtz(ds, args.out)
    print(f"wrote {args.out}")
    return ds


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
