"""Seeded runs of two checkouts of the port on the CPU, compared bit for bit.

In each checkout (its own interpreter, its own chip_smoke): a merge of
chip_smoke.build_problem's mono problem (20k observations, 1k
reflections, 50 images, d = 10, 4 layers) at --mc-samples=2, 20 steps
from a seeded generator, and the parallel crossvalidation form
(parallel/xval.py train_halves) over 2 x 2 image halves of another
problem, 10 steps. Prints one JSON line: how many parameter arrays and
loss values were compared and which differ. A change that must keep every
seeded trajectory (the draws, their order, the arithmetic) differs in
none.

    python tools/seeded_parity.py --old DIR [--new DIR]

DIR is a checkout, e.g. a `git archive` of the parent commit unpacked
under build/; --new defaults to this checkout.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

RUN = r"""
import dataclasses, sys, types
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(2)
import chip_smoke as cs
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.parallel.xval import (make_half_keys, stack_halves,
                                              train_halves)

model, params, trainer, inputs, _ = cs.model_on(
    "cpu", 0, 20000, 1000, 50, 10, 4, flags=dict(mc_samples=2))
trained, history = trainer.train(params, seeded_generator(3, "cpu"), inputs,
                                 20, chunk_size=10, device="cpu")
out = {"merge/" + k: v.numpy() for k, v in flatten_params(trained)}
out["merge/loss"] = np.asarray(history["loss"])
arrays, asu, _ = cs.build_problem(1, 20000, 1000, 50, 10)
parser = types.SimpleNamespace(**{**cs.MONO_DEFAULTS, "mlp_layers": 4,
                                  "seed": 1})
dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu, parser,
                 device="cpu")
_, params, trainer = dm.build_model()
halves = list(dm.split_data_by_image()) + list(dm.split_data_by_image())
stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                       dm.n_refl, dm.n_images)
trained, history = train_halves(
    dataclasses.replace(trainer, freeze=("scaler",)), params,
    make_half_keys(1, 2), stacked, 10, chunk_size=5, device="cpu")
out.update({"xval/" + k: v.numpy() for k, v in flatten_params(trained)})
out["xval/loss"] = np.asarray(history["loss"])
np.savez(sys.argv[2], **out)
"""


def run(checkout: str, path: str) -> dict:
    subprocess.run([sys.executable, "-c", RUN, checkout, path], check=True,
                   cwd=checkout)
    with np.load(path) as data:
        return dict(data)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=str(ROOT))
    args = ap.parse_args()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        old = run(str(Path(args.old).resolve()), str(Path(tmp) / "old.npz"))
        new = run(str(Path(args.new).resolve()), str(Path(tmp) / "new.npz"))
    keys = sorted(set(old) | set(new))
    differ = [k for k in keys if k not in old or k not in new
              or not np.array_equal(old[k], new[k])]
    print(json.dumps(dict(compared=len(keys), differ=differ)))


if __name__ == "__main__":
    main()
