"""Stack multiple intensity columns of one mtz into rows tagged by icol_id.

The port's scripts/stack_intensities:

    python -m careless_tpu_torch.scripts.stack_intensities in.mtz out.mtz

One copy of the table per J column that has a Sig/SIG partner, its values
in I and SigI, tagged by icol_id; the source columns dropped. A file with
no such pair raises ValueError, as the reference does.
"""
from argparse import ArgumentParser as _AP

import numpy as np

from ..xtal import DataSet, read_mtz, write_mtz


class ArgumentParser(_AP):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("input_mtz", type=str)
        self.add_argument("output_mtz", type=str)


def get_isigi_key_pairs(ds):
    for key in ds.columns:
        if ds.mtz_dtypes.get(key) == "J":
            if f"Sig{key}" in ds.columns:
                yield key, f"Sig{key}"
            elif f"SIG{key}" in ds.columns:
                yield key, f"SIG{key}"


def run(args):
    """Writes and returns the stacked DataSet."""
    ds = read_mtz(args.input_mtz)
    pairs = list(get_isigi_key_pairs(ds))
    if not pairs:
        raise ValueError("No objects to concatenate")
    stacks = []
    for n, (ikey, sigikey) in enumerate(pairs):
        stack = {k: ds[k] for k in ds.columns}
        stack["icol_id"] = np.full(len(ds), n)
        stack["I"] = ds[ikey]
        stack["SigI"] = ds[sigikey]
        stacks.append(stack)
    dropped = {k for pair in pairs for k in pair} - {"I", "SigI", "icol_id"}
    out = DataSet({k: np.concatenate([s[k] for s in stacks])
                   for k in stacks[0] if k not in dropped},
                  cell=ds.cell, spacegroup=ds.spacegroup,
                  mtz_dtypes={**ds.mtz_dtypes, "I": "J", "SigI": "Q",
                              "icol_id": "I"})
    write_mtz(out, args.output_mtz)
    print(f"wrote {args.output_mtz}")
    return out


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
