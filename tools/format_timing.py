#!/usr/bin/env python3
"""Seconds of the Laue formatter at the poly CLI phase's size, with the
harmonic and image group numbering (io/formatter.py's _ngroup) packing its
keys into one int64, as shipped, and with a row-wise np.unique of the
stacked keys, the fallback for keys too wide to pack.

    python3 tools/format_timing.py [--device cuda] [--spots 3000000]

Writes chip_smoke.synthetic_laue_mtz's file (chip_smoke's POLY_* sizes)
under build/format_timing/, reads it anew before each run, and times
LaueFormatter on it in the order packed, rows, rows, packed; both ways
must give the same Inputs. Prints the card and one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rows_ngroup(*keys):
    """_ngroup without packing: np.unique over the stacked key rows."""
    stacked = np.stack([np.asarray(k, np.int64).reshape(-1) for k in keys],
                       axis=1)
    _, inverse = np.unique(stacked, axis=0, return_inverse=True)
    return inverse.reshape(-1).astype(np.int64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spots", type=int, default=None)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from careless_tpu_torch.io import formatter
    from careless_tpu_torch.parser import parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    dev = torch.device(args.device)
    spots = args.spots or cs.POLY_SPOTS
    out = ROOT / "build" / "format_timing"
    out.mkdir(parents=True, exist_ok=True)
    mtz = str(out / "laue.mtz")
    (cols, types_), _, _, _ = cs.synthetic_laue_mtz(
        0, spots, cs.POLY_IMAGES, cs.POLY_CELL, cs.POLY_SPACEGROUP,
        cs.POLY_DMIN, cs.POLY_BAND)
    write_mtz(DataSet(cols, cell=UnitCell(*cs.POLY_CELL),
                      spacegroup=SpaceGroup.from_name(cs.POLY_SPACEGROUP),
                      mtz_dtypes=types_), mtz)
    del cols
    fmt = formatter.LaueFormatter.from_parser(
        parser.parse_args(["poly", cs.POLY_KEYS, mtz, str(out / "x")]))
    packed = formatter._ngroup
    seconds = {"packed": [], "rows": []}
    firsts = {}
    for way in ("packed", "rows", "rows", "packed"):
        formatter._ngroup = packed if way == "packed" else rows_ngroup
        datasets = fmt.read_files([mtz])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        inputs, _ = fmt(datasets, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[way].append(time.perf_counter() - t0)
        ids = {k: getattr(inputs, k).cpu() for k in
               ("refl_id", "image_id", "harmonic_id", "intensities")}
        firsts.setdefault(way, ids)
        del inputs, datasets
    formatter._ngroup = packed
    same = all(torch.equal(firsts["packed"][k], firsts["rows"][k])
               for k in firsts["packed"])
    if dev.type == "cuda":
        print(cs.card_line())
    print(json.dumps(dict(spots=spots, device=str(dev), same_inputs=same,
                          format_s=seconds)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
