"""Filter reflections by image based on CCpred.

The port's careless_tpu/stats/filter_by_image_cc.py: compute per-image
CCpred from predictions files, then filter the original unmerged MTZs by a
CC cutoff, writing *_filtered.mtz. Predictions and data files are told
apart by their names.
"""
import argparse
import re

import numpy as np

from ..io.formatter import get_first_key_of_dtype
from ..xtal import read_mtz, write_mtz
from ._lib import load_concat
from .image_cc import image_ccs


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument(
            "mtzs", nargs="+",
            help="A mix of *_predictions_#.mtz files and unmerged input "
                 "files. Filenames are used to interpret what they are; the "
                 "unmerged files must be in the order presented to careless.")
        self.add_argument("-m", "--method", default="weighted",
                          choices=["weighted", "pearson", "spearman"])
        self.add_argument("-c", "--cc-cutoff", required=True, type=float,
                          help="The correlation cutoff, between 0 and 1.")
        self.add_argument("-o", default=None, help="Output filename base.")


def is_predictions_filename(filename: str) -> bool:
    return re.match(r".+predictions_[0-9]+\.mtz$", filename) is not None


def predictions_id(filename: str) -> int:
    return int(filename[:-4].split("_")[-1])


def run_analysis(args):
    """Writes each data file's kept rows; returns the written paths."""
    data_mtzs = [f for f in args.mtzs if not is_predictions_filename(f)]
    predictions_mtzs = sorted(
        (f for f in args.mtzs if is_predictions_filename(f)),
        key=predictions_id)
    result = image_ccs(load_concat(predictions_mtzs), args.method,
                       "image_id")

    outputs = []
    for i, m in enumerate(data_mtzs):
        ds = read_mtz(m)
        out = (m[:-4] + "_filtered.mtz" if args.o is None
               else args.o + f"_{i}.mtz")
        # the image index of each row: pandas' groupby(BATCH).ngroup()
        batch = ds[get_first_key_of_dtype(ds, "B")]
        image_id = np.unique(batch, return_inverse=True)[1].reshape(-1)
        cc = result["CCpred"][result["file_id"] == i][image_id]
        write_mtz(ds.select(cc >= args.cc_cutoff), out)
        outputs.append(out)
    return outputs


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
