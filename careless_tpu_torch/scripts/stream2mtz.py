"""Convert CrystFEL stream file to an mtz for processing in careless-tpu.

The port's scripts/stream2mtz, through the port's read_crystfel
(careless_tpu_torch/xtal/stream.py: the native parser, built at its first
use):

    python -m careless_tpu_torch.scripts.stream2mtz x.stream -g "P 43 21 2"
"""
import argparse

from ..xtal import SpaceGroup, UnitCell, write_mtz
from ..xtal.stream import read_crystfel


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(formatter_class=argparse.RawTextHelpFormatter,
                         description=__doc__)
        self.add_argument(
            "stream",
            help="File in CrystFEL stream format. Must end with .stream")
        self.add_argument(
            "-o", "--out", type=str, default=None,
            help="Output filename. Defaults to <streamname>.mtz")
        self.add_argument(
            "-g", "--spacegroup", type=str, required=True,
            help="Space group (number or symbol) for the output mtz")
        self.add_argument(
            "-c", "--cell", nargs=6,
            metavar=("a", "b", "c", "alpha", "beta", "gamma"), type=float,
            default=None,
            help="Cell parameters (defaults to the stream header cell)")


def run(args):
    """Writes and returns the DataSet read from the stream."""
    out = args.out or f"{args.stream.removesuffix('.stream')}.mtz"
    ds = read_crystfel(args.stream,
                       spacegroup=SpaceGroup.from_name(args.spacegroup))
    if args.cell is not None:
        ds.cell = UnitCell(*args.cell)
    write_mtz(ds, out)
    print(f"wrote {out} ({len(ds)} reflections)")
    return ds


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
