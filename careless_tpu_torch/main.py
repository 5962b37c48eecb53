"""The port's CLI: `python -m careless_tpu_torch.main mono <metadata keys>
<file.{mtz,stream} ...> <out>` (or `poly <metadata keys> <file.mtz ...>
<out>` for Laue data) merges on the card (or on the CPU with
--disable-gpu) and writes careless_tpu/main.py's file set:
`<out>_<i>.mtz` (one per ASU), `<out>_history.csv`,
`<out>_predictions_<i>.mtz`, `<out>_scale.npz` and
`<out>_structure_factor.npz`; `devices` lists the CUDA devices.
`--scale-file` and `--structure-factor-file` start from the parameters of
an earlier merge (written by either package); with `--freeze-scales` the
scales stay as loaded. `--test-fraction` holds out that fraction of the
rows (Laue: of the harmonic groups), scores their NLL every
`--validation-frequency` steps into the history's `NLL_val` column, and
appends them to the prediction files with `test` = 1. `--checkpoint-every
N` writes `<out>_checkpoint.npz` every N steps and at the end;
`--resume-from` continues from such a file (written by either package;
one the port wrote repeats the uninterrupted run bit for bit).
`--merge-half-datasets` then merges 2 x `--half-dataset-repeats` halves of
the images with the trained scales frozen and writes them, with `repeat`
and `half` columns, to `<out>_xval_<i>.mtz`: one after another
(`--xval-mode=serial`, the JAX package's loop) or all in each step
(`--xval-mode=parallel`, parallel/xval.py). `--save-data-manager` also
writes `<out>_data_manager.pickle` (DataManager.from_pickle reads it, on
the card or the CPU); `--profile-dir=DIR` records the main merge's
training under torch.profiler (CPU, and CUDA on the card) and writes its
Chrome/TensorBoard trace, `<host>_<pid>.<ns>.pt.trace.json`, into DIR
(the JAX package writes an XLA trace there).

`--num-devices N` (N > 1) trains on N devices, one process each
(torch.multiprocessing's spawn; NCCL on cards 0 .. N - 1, gloo ranks on the
CPU with --disable-gpu; under torchrun each process is one rank): every
rank reads and formats the same files and keeps its shard of the rows
(`--shard-axis obs`, parallel/shard.py) or of the Monte Carlo samples
(`--shard-axis mc`), and rank 0 writes the outputs; the half merges go to
the ranks as well (serial: each half sharded like the main merge;
parallel: whole halves to each rank).

Counterpart of careless_tpu/main.py's main, run_careless and
run_half_dataset_crossvalidation. The flags that steer only JAX raise
NotImplementedError naming the flag when given a value other than the
default, so a JAX command line parses here and never runs something else
than it asks for.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device, seeded_generator
from .parallel import distributed
from .parallel.shard import (check_devices, sample_range, sample_shard,
                             shard_inputs)
from .parallel.xval import (SEED_STRIDE, half_params, make_half_keys,
                            train_halves_spread)
from .xtal import concat_datasets, write_mtz

# (flag, attribute, value that asks for what the port does not do)
_UNPORTED = (
    ("--run-eagerly", "run_eagerly", bool),
    ("--platform", "platform", lambda v: v is not None),
    ("--rng-impl", "rng_impl", lambda v: v is not None),
    ("--jax-debug", "jax_debug", bool),
)


def main(argv=None) -> Optional[dict]:
    """Parse argv (default: the command line) and run it; returns
    run_careless's timings."""
    from . import __version__
    print(f"careless-tpu-torch version {__version__}")
    from .parser import parser
    args = parser.parse_args(argv)
    return run_careless(args)


def check_ported(parser) -> None:
    """Raise NotImplementedError naming the first flag whose value asks for
    something the port does not do."""
    for flag, attr, selects in _UNPORTED:
        if selects(getattr(parser, attr, None)):
            raise NotImplementedError(f"{flag} is not ported yet")


def cli_device(parser, device: DeviceLike = None) -> torch.device:
    """`device` when given, else the CPU under --disable-gpu, else card
    --device-id (made current, so that every entry point uses it)."""
    if device is not None:
        return resolve_device(device)
    if parser.disable_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --disable-gpu "
                           "to run on the CPU")
    count = torch.cuda.device_count()
    if not 0 <= parser.device_id < count:
        raise ValueError(f"--device-id {parser.device_id} out of range: only "
                         f"{count} device(s) available")
    torch.cuda.set_device(parser.device_id)
    return torch.device("cuda", parser.device_id)


def sharded(parser) -> bool:
    """Whether this run is one rank of a --num-devices run."""
    return (parser.num_devices or 0) > 1 and distributed.is_initialized()


def launch(parser) -> Optional[dict]:
    """Run --num-devices N ranks of run_careless, one process each: NCCL
    on cards 0 .. N - 1, or with --disable-gpu gloo on the CPU (as many
    ranks as it has cores); under torchrun this process is one of them.
    Refuses more devices than there are, and an --mc-samples that
    --shard-axis=mc cannot divide, with the JAX package's messages.
    Returns rank 0's timings."""
    n = parser.num_devices
    if "WORLD_SIZE" in os.environ:
        backend = "gloo" if parser.disable_gpu else "nccl"
        device = (torch.device("cpu") if parser.disable_gpu
                  else torch.device("cuda", distributed.local_rank()))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        distributed.initialize(backend)
        if distributed.world_size() != n:
            raise ValueError(f"--num-devices {n} under a torchrun world of "
                             f"{distributed.world_size()}")
        return run_careless(parser, device)
    if parser.disable_gpu:
        backend, available = "gloo", os.cpu_count() or 1
        devices = ["cpu"] * n
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--disable-gpu to run on the CPU")
        backend, available = "nccl", torch.cuda.device_count()
        devices = [f"cuda:{r}" for r in range(n)]
    check_devices(n, available)
    if parser.shard_axis == "mc":
        sample_range(parser.mc_samples or 1, 0, n)
    if backend == "nccl":
        from .kernels._build import library
        library()   # built once here, not by every rank
    return distributed.spawn(_rank_main, n, (parser,), backend, devices,
                             max(1, torch.get_num_threads() // n))[0]


def _rank_main(rank: int, world: int, device: torch.device, parser):
    """One spawned rank of launch."""
    return run_careless(parser, device)


def training_rows(dm, inputs, model, parser, dev):
    """(the rows `inputs` train on, with plans, and their Shard or None):
    DataManager.planned_inputs in one process; in a --num-devices run this
    rank's cut of planned_rows (--shard-axis obs) or all planned rows and
    this rank's samples (mc)."""
    if not sharded(parser):
        return dm.planned_inputs(inputs).inputs, None
    rank, world = distributed.rank(), distributed.world_size()
    if parser.shard_axis == "mc":
        planned = dm.planned_inputs(inputs).inputs
        return planned, sample_shard(model.mc_samples, rank, world,
                                     planned.n_obs)
    return shard_inputs(dm.planned_rows(inputs).inputs, rank, world,
                        dm.n_refl, dm.n_images, dev)


def write_history(history: dict, path: str) -> None:
    """The history as pandas' DataFrame(history).to_csv(path,
    index_label="step") writes it: a `step` column, then each metric;
    floats in their shortest repr, NaN as an empty field."""
    keys = list(history)
    n = len(history[keys[0]]) if keys else 0

    def field(v):
        return "" if isinstance(v, float) and math.isnan(v) else repr(v)
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["step"] + keys)
        for i in range(n):
            out.writerow([i] + [field(float(history[k][i])) for k in keys])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profiled(profile_dir: Optional[str], dev: torch.device):
    """A context that records what runs in it with torch.profiler (host
    ops, and the card's kernels and copies on a CUDA device) and writes
    the Chrome/TensorBoard trace into profile_dir when it ends; a context
    that does nothing without a directory. Every event is kept: the trace
    grows with the steps it covers."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_careless(parser, device: DeviceLike = None) -> Optional[dict]:
    """One merge from the parsed flags on `device` (None: --disable-gpu's
    CPU or card --device-id; --num-devices N > 1: launch's N ranks, each
    on its own). Returns the host seconds of its parts:
    set-up (setup_s, the sum of build_s, the kernels' build where the
    checkout has none yet, and the stream parser's for .stream files;
    read_s, the reflection files; format_s, the
    formatter; model_s, the data manager, the test split, model and warm
    start; plans_s, the row layout and gather plans, Laue's harmonic-chain
    layout included), training (train_s), the history's rows (`steps`, a resumed
    run's earlier steps included), and output (output_s: results,
    predictions, writing); with --merge-half-datasets also the half
    merges' xval_setup_s (splits, models, row layout and plans), xval_train_s
    (their training; in the parallel form also the stacked layout of the
    halves) and xval_output_s (results and writing). From .stream files,
    read_parser also names the parser that read them, "native" or
    "python"."""
    if parser.type == "devices":
        print("#############################################")
        print("# PyTorch can access the following devices  #")
        print("#############################################")
        for i in range(torch.cuda.device_count()):
            print(f" - cuda:{i}: {torch.cuda.get_device_name(i)}")
        print(" - cpu")
        return None
    check_ported(parser)
    if (parser.num_devices or 0) > 1 and not distributed.is_initialized():
        return launch(parser)
    if sharded(parser) and distributed.world_size() != parser.num_devices:
        raise ValueError(f"--num-devices {parser.num_devices} in a process "
                         f"group of {distributed.world_size()}")
    writes = not sharded(parser) or distributed.rank() == 0

    from .io.formatter import LaueFormatter, MonoFormatter
    from .io.manager import DataManager
    from .utils.checkpoint import load_params
    from .xtal import _native, stream

    dev = cli_device(parser, device)
    times = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(dev)
        t1 = time.perf_counter()
        times[name] = t1 - t0
        t0 = t1

    if dev.type == "cuda":
        from .kernels._build import library
        library()   # built at the checkout's first run: set-up, not training
    if any(f.endswith(".stream") for f in parser.reflection_files):
        # the stream parser likewise; without a compiler read_crystfel
        # reads with the Python parser and says so
        with contextlib.suppress(_native.NoCompiler):
            _native.library()
    lap("build_s")
    formatter = (LaueFormatter if parser.type == "poly"
                 else MonoFormatter).from_parser(parser)
    stream.last_parser = None
    datasets = formatter.read_files(parser.reflection_files)
    lap("read_s")
    if stream.last_parser is not None:
        # a string beside the float parts: setup_s sums those by name
        times["read_parser"] = stream.last_parser
        print(f"Read the stream files with the {stream.last_parser} parser "
              f"in {times['read_s']} s")
    inputs, rac = formatter(datasets, device=dev)
    del datasets
    lap("format_s")
    dm = DataManager(inputs, rac, parser=parser, device=dev)
    # split before build_model, which the JAX CLI also does: numpy's
    # generator then draws the same rows
    if parser.test_fraction is not None:
        train, test = dm.split_data_by_refl(parser.test_fraction)
    else:
        train, test = dm.inputs, None
    model, params, trainer = dm.build_model()
    if parser.scale_file is not None:
        params["scaler"] = load_params(parser.scale_file, params["scaler"])
    if parser.structure_factor_file is not None:
        params["posterior"] = load_params(parser.structure_factor_file,
                                          params["posterior"])
    lap("model_s")
    planned, shard = training_rows(dm, train, model, parser, dev)
    validation = None if test is None else dm.planned_inputs(test).inputs
    generator = seeded_generator(parser.seed, dev)
    lap("plans_s")
    base = parser.output_base
    with profiled(parser.profile_dir, dev):
        params, history = trainer.train(
            params, generator, planned, parser.iterations,
            chunk_size=parser.steps_per_compile, device=dev,
            validation_data=validation,
            validation_frequency=parser.validation_frequency,
            checkpoint_path=(base + "_checkpoint" if parser.checkpoint_every
                             else None),
            checkpoint_frequency=parser.checkpoint_every,
            resume_from=parser.resume_from, shard=shard)
        _sync(dev)
    lap("train_s")
    if writes:
        write_outputs(dm, model, params, history, train, test, parser)
    lap("output_s")
    if parser.merge_half_datasets:
        times.update(run_half_dataset_crossvalidation(dm, params, parser,
                                                      dev))

    if parser.embed and writes:
        try:
            from IPython import embed
            embed(colors="Linux")
        except ImportError:
            pass
    times["setup_s"] = sum(times[k] for k in ("build_s", "read_s",
                                              "format_s", "model_s",
                                              "plans_s"))
    times["steps"] = len(next(iter(history.values()), []))
    return times


def write_outputs(dm, model, params: dict, history: dict, train, test,
                  parser) -> None:
    """The merge's files from the trained params, on one device from all
    rows: the merged MTZs, the history, the parameters, the pickle with
    --save-data-manager, and the predictions (the held-out rows last,
    test = 1)."""
    from .utils.checkpoint import save_params

    base = parser.output_base
    posterior_dist = model.posterior.distribution(params["posterior"])
    for i, ds in enumerate(dm.get_results(posterior_dist, inputs=train)):
        write_mtz(ds, base + f"_{i}.mtz")
    write_history(history, base + "_history.csv")
    save_params(base + "_structure_factor", params["posterior"])
    save_params(base + "_scale", params["scaler"])
    if parser.save_data_manager:
        dm.to_pickle(base + "_data_manager.pickle")
    predictions = dm.get_predictions(model, params, train, test_value=0)
    if test is not None:
        # the train rows (test = 0), then the held-out rows (test = 1)
        predictions = map(concat_datasets, zip(
            predictions, dm.get_predictions(model, params, test,
                                            test_value=1)))
    for file_id, ds in enumerate(predictions):
        write_mtz(ds, base + f"_predictions_{file_id}.mtz")


def run_half_dataset_crossvalidation(dm, trained_params: dict, parser,
                                     dev: torch.device) -> dict:
    """Merge 2 x --half-dataset-repeats halves of the images (each
    repeat's split drawn from dm.rng, so the JAX package's halves) with
    the trained scaler frozen, each half from a fresh model and the
    generator seeded with seed + 7919 (2 repeat + half + 1), and write
    their results with int32 `repeat` and `half` columns (MTZ type I), in
    split order, to <out>_xval_<file>.mtz (careless_tpu/main.py:120-229).
    In a --num-devices run every rank takes part: the serial form trains
    each half sharded as the main merge, the parallel form gives each rank
    whole halves (train_halves_spread); rank 0 writes. Returns xval_setup_s,
    xval_train_s and xval_output_s."""
    times = {"xval_setup_s": 0.0, "xval_train_s": 0.0, "xval_output_s": 0.0}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(dev)
        t1 = time.perf_counter()
        times[name] += t1 - t0
        t0 = t1

    def frozen_scaler_model():
        model, params, trainer = dm.build_model()
        params["scaler"] = trained_params["scaler"]
        return model, params, dataclasses.replace(trainer,
                                                  freeze=("scaler",))

    results = [[] for _ in dm.asu_collection]

    def collect(model, posterior_params, half, repeat, half_id):
        dist = model.posterior.distribution(posterior_params)
        for file_id, ds in enumerate(dm.get_results(dist, inputs=half)):
            ds["repeat"] = np.int32(repeat)
            ds["half"] = np.int32(half_id)
            ds.mtz_dtypes.update({"repeat": "I", "half": "I"})
            results[file_id].append(ds)

    steps, chunk = parser.iterations, parser.steps_per_compile
    writes = not sharded(parser) or distributed.rank() == 0
    if parser.xval_mode == "serial":
        for repeat in range(parser.half_dataset_repeats):
            for half_id, half in enumerate(dm.split_data_by_image()):
                model, params, trainer = frozen_scaler_model()
                planned, shard = training_rows(dm, half, model, parser, dev)
                generator = seeded_generator(
                    parser.seed + SEED_STRIDE * (2 * repeat + half_id + 1),
                    dev)
                lap("xval_setup_s")
                params, _ = trainer.train(params, generator, planned, steps,
                                          chunk_size=chunk, device=dev,
                                          shard=shard)
                lap("xval_train_s")
                if writes:
                    collect(model, params["posterior"], half, repeat,
                            half_id)
                lap("xval_output_s")
    else:
        halves = []
        for _ in range(parser.half_dataset_repeats):
            halves.extend(dm.split_data_by_image())
        model, params, trainer = frozen_scaler_model()
        planned = [dm.planned_rows(half).inputs for half in halves]
        lap("xval_setup_s")
        trained, _ = train_halves_spread(
            trainer, params,
            make_half_keys(parser.seed, parser.half_dataset_repeats),
            planned, dm.n_refl, dm.n_images, steps, chunk_size=chunk,
            device=dev)
        lap("xval_train_s")
        if writes:
            for k, half in enumerate(halves):
                collect(model, half_params(trained, k, trainer.freeze)[
                    "posterior"], half, *divmod(k, 2))
    if writes:
        for file_id, parts in enumerate(results):
            write_mtz(concat_datasets(parts),
                      parser.output_base + f"_xval_{file_id}.mtz")
    lap("xval_output_s")
    return times


if __name__ == "__main__":
    main()
