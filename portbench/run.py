"""One run of one cell of the benchmark of careless_tpu_torch on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the problem from the seed, builds the model, the training
layout and its plans as the CLI does, drives the merge through its first
three steps by the timed call (the steps the comparison reads), and times
one chunk of steps to size the window. The window is one
`Trainer.train` call of whole chunks that lasts about --seconds. With
--trace 1 a further chunk runs under torch.profiler, and the per-layer
metrics are read from it. After the window the port's state is freed and
the plain reference (reference/) follows the same three steps; `correct`
holds the comparison's numbers (correct.py) under the cell's limits
(workloads/<cell>.json).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
numbers compared with their limits, which also end standard error. Without
a CUDA card, or with fewer cards than the cell asks for, the run exits
with code 2 and prints no result; it never falls back to the CPU. If JAX
or the JAX package is loaded once the comparison is made, just before
the result would be printed, it exits with code 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from . import correct, counts, spec, system, trace  # noqa: E402
from .peaks import bound, peaks  # noqa: E402
from .problem import build_problem  # noqa: E402

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "careless_tpu")
# the steps of the merge the comparison reads
CHECK_STEPS = 3
# the fixed cache directories inside the checkout (the port builds its
# kernels into build/careless_tpu_torch/ by itself; PyTorch keeps the
# kernels NVRTC compiles at first use, log_ndtr, lgamma and erfinv among
# them, in PYTORCH_KERNEL_CACHE_PATH)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def seed_keys(seed: int) -> types.SimpleNamespace:
    """The generator seeds of the run's Trainer.train calls, from --seed:
    the comparison's (the reference draws from the same), the sizing
    chunk's, the window's and the traced chunk's."""
    s = seed & (2 ** 62 - 1)
    return types.SimpleNamespace(check=s, size=s ^ (1 << 62),
                                 window=s ^ (2 << 62), trace=s ^ (3 << 62))


def traced_chunk(built, params, seed, steps, device, name, scaler):
    """Run one call of one chunk of `steps` steps under torch.profiler;
    returns what the per-layer readers read of it. `scaler` is the scaler
    MLP's (rows, input columns, width, layers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from careless_tpu_torch import kernels

    peak_flops, peak_bw = peaks(name)
    kernels.reset_launches()
    with system.recorded_gathers() as gathers:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, window_s = system.timed(built, params, seed, steps, steps,
                                          device)
    launched = dict(kernels.LAUNCHES)
    bounds = {"k1": system.k1_bound(launched, *scaler, peak_flops,
                                    peak_bw),
              "gather": sum(bound(*counts.gather(*g), peak_flops,
                                  peak_bw)[0] for g in gathers)}
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total
              and not getattr(e, "is_user_annotation", False)]
    rows, stands_for, complete = trace.window_device_times(
        events, launched, steps, kernels.PROFILED_KERNELS)
    device_iv, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device_iv.append(span)
        elif not e.name.startswith("cuda"):
            host.append(span + (e.name,))
    kept = sum(e.count for e in events)
    stood = sum(stands_for.values())
    say(f"trace: {steps} steps in {window_s:.4f} s; device records kept "
        f"{kept} of the {stood:.0f} launches they stand for "
        f"({stood - kept:.0f} dropped); every port kernel recorded: "
        f"{complete}; {len(gathers)} gathers recorded of "
        f"{launched['gather'] + launched['gather_stream']} launched")
    busy_s = sum(r[0] for r in rows) * steps / 1e3
    return dict(rows=rows, stands_for=stands_for, complete=complete,
                steps=steps, window_s=window_s, busy_s=busy_s,
                bounds=bounds, groups=kernels.PROFILED_KERNELS,
                idle_gaps=trace.label_gaps(trace.idle_gaps(device_iv), host))


def main(argv=None, device=None, traffic=None) -> int:
    """The run; `device` and `traffic` are for the CPU tests alone (the
    plain versions on the CPU at a size they give)."""
    args = parse(argv)
    cell = spec.cell(args.workload)
    traffic = traffic or cell.traffic
    root = spec.ROOT
    for var, sub in CACHES.items():
        # PyTorch makes no parent directory of its kernel cache
        os.environ[var] = str(root / "build" / "portbench" / sub)
        os.makedirs(os.environ[var], exist_ok=True)
    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            say("no CUDA card; the benchmark measures the card only")
            return 2
        if torch.cuda.device_count() < cell.entry["chips"]:
            say(f"{cell.name} needs {cell.entry['chips']} cards; "
                f"{torch.cuda.device_count()} found")
            return 2
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, settings = cell.config, cell.settings
    times = {}
    if on_card:
        from careless_tpu_torch.kernels._build import library
        t = time.perf_counter()
        library()
        times["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    problem = build_problem(args.seed, traffic["observations"],
                            traffic["reflections"], traffic["images"],
                            config["metadata_keys"],
                            laue=config["mode"] == "poly")
    times["problem_s"] = time.perf_counter() - t
    built = system.build(problem, config, device, times)
    chunk = config["cli"]["steps_per_compile"]
    keys = seed_keys(args.seed)
    t = time.perf_counter()
    first = system.first_steps(built, keys.check, CHECK_STEPS, chunk, device)
    times["first_steps_s"] = time.perf_counter() - t
    trained = first.pop("trained")
    _, _, wall = system.timed(built, trained, keys.size, chunk, chunk,
                              device)
    times["sizing_s"] = wall
    steps = max(1, round(args.seconds / wall)) * chunk
    setup_s = time.perf_counter() - T_START

    _, history, wall = system.timed(built, trained, keys.window, steps,
                                    chunk, device)
    done = len(history["loss"])
    failed = steps - sum(1 for x in history["loss"] if math.isfinite(x))
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    say(f"set-up {setup_s:.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    say(f"window: {done} of {steps} steps in {wall:.4f} s, "
        f"{done / wall:.4f} steps/s; peak {peak_bytes} bytes")
    scaler = (problem.n_obs, config["metadata_keys"],
              config["cli"]["mlp_width"] or config["metadata_keys"],
              config["cli"]["mlp_layers"])
    traced = None
    if args.trace:
        traced = traced_chunk(built, trained, keys.trace, chunk, device,
                              name, scaler)
    card = card_line() if on_card else "cpu"

    run = types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, steps=done, wall=wall,
        setup_s=setup_s, times=times, peak_bytes=peak_bytes,
        peaks=peaks(name),
        trace=traced,
        model_flops_per_step=counts.model_flops_per_step(*scaler))
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the port's state goes before the reference runs
    del built, trained, history
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from .reference import load
    t = time.perf_counter()
    ref = load(config["reference"]).Reference(problem, config, device)
    expected = ref.run(keys.check, CHECK_STEPS)
    del ref
    say(f"reference: {time.perf_counter() - t:.4f} s")
    values = correct.readings(first, expected)
    limits = settings["limits"]
    ok = correct.judge(values, limits) and failed == 0

    out = {"correct": ok, "attempted": steps, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                      "count": cell.entry["chips"],
                      "memory_peak_bytes": peak_bytes}}
    if traced is not None:
        out["device"].update(busy_s=traced["busy_s"],
                             window_s=traced["window_s"])
        out["breakdown"] = {
            "device_ops": [[k, ms * traced["steps"] / 1e3]
                           for ms, _, k in traced["rows"][:10]],
            "idle_gaps": traced["idle_gaps"]}
    out["card"] = card
    out["compared"] = {k: {"value": values[k], "limit": limits[k]}
                       for k in limits}
    out["compared"]["failed_steps"] = {"value": failed, "limit": 0}
    # whatever the port, the reference or the comparison loaded, in the
    # process that prints the result
    found = loaded_forbidden()
    if found:
        say("loaded, and never to be: " + ", ".join(found))
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
