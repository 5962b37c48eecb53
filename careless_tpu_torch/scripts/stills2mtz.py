"""Convert DIALS stills-process output (refl + expt files) to an MTZ.

The port's scripts/stills2mtz, as far as it runs without DIALS: the same
flags and, where DIALS/cctbx cannot be imported, the same refusal. The
conversion itself needs DIALS (`dials.array_family.flex`,
`dxtbx.model.experiment_list`) and waits for an installation to port and
test it against.
"""
import argparse


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("refl_file", help="DIALS .refl reflection table")
        self.add_argument("expt_file", help="DIALS .expt experiment list")
        self.add_argument("-o", "--out", default="stills.mtz")


def run(args):
    try:
        from dials.array_family import flex  # noqa: F401
        from dxtbx.model.experiment_list import ExperimentListFactory  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            "stills2mtz requires a DIALS/cctbx installation "
            f"(import failed: {e}). Install DIALS and re-run, or use "
            "scripts/stream2mtz for CrystFEL-processed stills.")
    raise NotImplementedError(
        "stills2mtz's conversion is not ported yet; run the reference "
        "script scripts/stills2mtz")


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
