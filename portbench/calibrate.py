"""The readings the limits of a cell's comparison are set from, on the card
at the cell's own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103

For each of --seeds, the port's first three steps by the timed call
(system.first_steps, as a run makes them) against the reference: the
sound runs, whose largest reading of each number is its lower reading. For
each of --control-seeds, the reference in TF32 (the control: the precision
below the configuration's float32 with TF32 off) and the reference with
half of the batch left out and the rest's sum doubled (a fault), each put
in the port's place against the reference. A step that returns its state
unchanged reads 1 on change_gap without a run. One JSON line a reading,
then one with the lower and upper readings of each number. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import correct, run, spec, system
from .problem import build_problem
from .reference import load


def main(argv=None, device=None, traffic=None) -> int:
    """`device` and `traffic` are for the CPU tests alone."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA card", file=sys.stderr)
            return 2
        from careless_tpu_torch.kernels._build import library
        library()
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, traffic or cell.traffic
    chunk = config["cli"]["steps_per_compile"]
    found = {"sound": [], "tf32": [], "half": []}

    def problem_of(seed):
        return build_problem(seed, traffic["observations"],
                             traffic["reflections"], traffic["images"],
                             config["metadata_keys"],
                             laue=config["mode"] == "poly")

    def emit(kind, seed, values, t0):
        found[kind].append(values)
        print(json.dumps(dict(cell=cell.name, kind=kind, seed=seed,
                              seconds=time.perf_counter() - t0, **values)),
              flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        problem = problem_of(seed)
        built = system.build(problem, config, device, {})
        key = run.seed_keys(seed).check
        port = system.first_steps(built, key, run.CHECK_STEPS, chunk, device)
        port.pop("trained")
        del built
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = load(config["reference"]).Reference(problem, config, device)
        emit("sound", seed, correct.readings(port, ref.run(key), True), t0)
        del ref, port

    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        ref = load(config["reference"]).Reference(problem_of(seed), config,
                                                  device)
        key = run.seed_keys(seed).check
        expected = ref.run(key)
        emit("tf32", seed, correct.readings(ref.run(key, tf32=True),
                                            expected, True), t0)
        emit("half", seed, correct.readings(ref.run(key, fault="half"),
                                            expected, True), t0)
        del ref, expected
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    summary = {}
    for k in correct.NAMES:
        summary[k] = {kind: max(v[k] for v in vals) if kind == "sound"
                      else min(v[k] for v in vals)
                      for kind, vals in found.items() if vals}
        summary[k]["unchanged"] = 1.0 if k == "change_gap" else None
    print(json.dumps(dict(cell=cell.name, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
