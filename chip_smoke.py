#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (careless_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own lines:
  1. card: the card's name and power limit, torch/CUDA versions, and the
     time to build the kernels from csrc/ (nvcc, one process per source);
  2. kernels: every kernel of the ported paths (K1-fwd and K1-bwd in their
     four instantiations: with the head or the trunk only, f32 or bf16
     operands; K2, K3, K4-fwd, K4-bwd) at the main path's shapes, held
     against its plain PyTorch version on the same inputs and timed by CUDA
     events (median of 30 launches after warm-up) beside its plain version,
     the one PyTorch call computing the same function where there is one,
     and its bound on this card; the gathers (K2, K5) also bitwise against
     index_select, with their host time per call over back-to-back calls
     (host_us) and their device time with a warm L2 and after an L2 flush
     (cold_device_ms), each beside index_select's, and K2's launch path
     timed step by step; K3 also passes a statistical gate at n = 2^22; K4
     is held for all five likelihood kinds, with and without supplied
     noise (its forward also at an offset that is not a multiple of 4),
     and its in-kernel normals bitwise against K3's, its Student-t
     gradients per observation within the rounding of ipred and against
     f64 at eight more seeds (studentt_check); K5 on the JAX package's 300k
     swap permutation, bitwise against its plain version and x[perm]; K1
     at 20 layers of width 28 (d_in 28) and width 32 (d_in 128), whose
     backward runs at a shorter tile; each K1-bwd row names the kernel
     kernels.trunk_route took (csrc/trunk_bwd.cu for f32,
     csrc/trunk_bwd_bf16.cu for bf16, csrc/trunk.cu's backward for a
     shape whose shared memory fits not even one warp of those, or
     csrc/trunk_wide.cu) and, where it took one of the first two, times
     csrc/trunk.cu's backward on the same inputs beside it; csrc/
     trunk_wide.cu (K1 past width 32 or past a block's shared memory) in
     its four instantiations at 100k rows at widths 33 to 128 and at 64
     layers of width 32, its forward bit for bit csrc/trunk.cu's at two
     shapes both take (width 32 over d_in 32, and the main path's in the
     four instantiations), its dW bitwise repeatable, and its head f32
     pair at the `wide` slice's 1M shape, and on a line of its own the earlier
     design's device times, which are constants and not measured here; the
     K1, K3 and K4 launchers' host time per call, measured before any
     profiler capture, sits in their rows
     (host_us; K3's beside torch.randn's, with randn's device time; K3 is
     also held at an offset that is not a multiple of 4);
  3. check: the port's loss and every parameter gradient at a small size on
     the card against the same computation on the CPU (plain versions), at
     mc = 1 for the defaults, --image-layers 2, --mlp-dtype bfloat16,
     both, --mlp-width 128, --mlp-width 128 --mlp-dtype bfloat16,
     --analytic-kl, the double-Wilson prior of two files (r trained) and
     the library-level parts (library_parts), and
     at mc = 2 through K4 for the flag sets of slices (a) and
     (b); then the card's fused ELBO against its unfused ELBO; then Laue at
     50k observations with the VMEM cap lowered so that K5 runs, card
     against CPU, and the run-aligned ELBO against the plan_convolve one;
  4. slices at 1,000,000 observations, 50,000 reflections, 2,000 images,
     10 metadata columns and a 20-layer MLP of width 10, trained full-batch
     with Adam, from the CLI's mono defaults (`careless-tpu mono
     dHKL,image_id ...`): the default merge (mc = 1, 300 steps); (a)
     --mc-samples=2, where --fused-kernel=auto takes K4 (300 steps); (b)
     (a) with --studentt-likelihood-dof=4 --refine-uncertainties (100
     steps); the scaler slices --image-layers 2 (NeuralImageScaler through
     K1 trunk-only), --mlp-dtype bfloat16 (K1 bf16) and both (K1 trunk-only
     bf16), 100 steps each; the `wide` slice, --mlp-width 128 (20 steps),
     whose K1 runs in csrc/trunk_wide.cu, with its step time, device time,
     busy share and peak memory on lines of their own (the profile's
     kernel times scaled to the launches its dropped records stand for,
     window_device_times). Every loss finite,
     the loss falling, and each kernel of the slice launched by that run
     (the counts are set to 0 just before it), each slice's own K1
     instantiation once per step and every other not at all, K2 as often
     as GATHERS_PER_STEP says;
  5. the CLI: a seeded unmerged MTZ of 1,000,000 observations (~52k
     reflections in P 21 21 21 to 1.5 A, 2,000 images, 10 metadata
     columns; synthetic_mtz) merged by `careless_tpu_torch.main.main(["mono",
     ...])` in this process for 300 steps (the default slice's model): the
     five output files, the merged F against the generator's true F, N
     against the observations, one prediction row per observation, and the
     kernels' launches (cli_phase), with the CLI's set-up, steps/s and
     output times on lines of their own; then the Laue merge through
     `main(["poly", ...])` on a seeded 3,000,000-spot Laue MTZ (PYP in
     P 63 to 1.6 A, band 0.95-1.25 A, 4,000 images, 10 metadata keys;
     synthetic_laue_mtz), 300 steps, its merged F against the true F, N
     against the expanded rows, one prediction row per harmonic group, K5
     once a step, the path's kernels held at its shapes, and the "on" merge
     from the first run's scales, frozen, whose scale file comes back bit
     for bit and which launches no K1-bwd and no image-scale backward
     (poly_cli_phase); then a serial-crystallography merge from a
     seeded CrystFEL stream of 500,000 reflections on 2,500 crystals
     through `main(["mono", ...])`, 300 steps, the path's K1, K2 and K3
     held at its shapes, its merged F against the true F, with the stream's parse
     seconds and the native parser that read it, held against the Python
     reader on a 50,000-reflection stream (stream_cli_phase); then a
     merge of DIALS stills: a seeded table of 1,000,000 reflections on
     5,000 stills (P 1 21 1 to 1.8 A, like MbCO myoglobin) converted by
     the port's scripts/stills2mtz under a stand-in for DIALS
     (dials_stand_in; it reads .npz tables, not DIALS's files), merged
     300 steps through `main(["mono", ...])` with eight metadata keys,
     its merged F against the true F and its K1, K2 and K3 launches and
     held errors at its shapes (stills_phase); each with
     set-up by part, steps/s, output seconds and peak GB; between the mono
     and poly merges, checkpoints and the held-out test fraction
     (resume_phase): three mono merges of the CLI phase's MTZ with
     --test-fraction=0.1 --validation-frequency=10, A uninterrupted for
     200 steps, B 100 steps with --checkpoint-every=100, C resumed from B's
     checkpoint to 200, C's files equal to A's bit for bit, the held-out
     rows last in the prediction file with test = 1, NLL_val finite and
     falling, each run's launches (validation and prediction passes
     included), the checkpoint's size and write time, and K1, K2 and K3
     held at the shapes of the train rows and of the held-out rows; then
     half-dataset crossvalidation (xval_phase): the CLI phase's MTZ merged
     100 steps with --merge-half-datasets --half-dataset-repeats=2 in each
     --xval-mode, the two forms' _xval_0.mtz equal within rtol 1e-3 / atol
     1e-3, each half's N its rows, the main run's scaler kept bit for bit,
     the launches of the main run and of the half merges (the parallel
     form: K1-fwd once a step for all four halves, K3 once per half, K2
     as one merge, no K1-bwd), the half path's K1-fwd, K2 and K3 held at
     the stacked 2M rows, each form's set-up, merging seconds and steps/s;
     then multi-device training (shard_phase): the default slice's 1M
     observations on the observation axis, the same at --mc-samples=2
     (K4) on the Monte Carlo axis and a 2M-row Laue problem whose chain
     permute streams in each shard (K5), 100 steps each, unsharded; then
     through the sharded Trainer at NCCL world size 1, bit for bit the
     unsharded run, and in two gloo ranks spawned on this card, each
     rank's step-0 loss and gradients against the unsharded run's, the
     merged F's correlation with it, the ranks' parameters bit for bit
     equal, each rank's launches and its kernels held at its shard's
     shapes and offsets (hold_shard_kernels; shard_<run>_max_abs_err and
     shard_<run>_launches in the kernels line), and --num-devices 2
     refused on the one card; its times are gloo on one card, not NCCL
     across cards;
     then the statistics tools (stats_phase): the same MTZ merged 100
     steps with --anomalous, the parallel half merges and a test fraction
     of 0.1, each careless_tpu_torch.stats tool run on its outputs (their
     tables' rows, the overall CC1/2 gated by STATS_MIN_CCHALF,
     completeness, rescale's factors, the filtered file), and
     scripts/to_intensities --anomalous on the card against the CPU, each
     tool's seconds on a `stats` line;
     and the double-Wilson prior (prior_phase): a parent MTZ and a child
     MTZ drawn at r = 0.9 from it, merged 100 steps with --separate-files
     --double-wilson-parents=None,0 --double-wilson-r=0.,0.9
     --optimize-double-wilson-r, rDW_1 inside (-1, 1), each file's merged
     F against its true F, the child merged alone beside it; then the
     library-level parts (library_phase) at the default slice's full
     width: RiceWoolfsonPosterior, a normal ReferencePrior on 60 % of the
     reflections (a seeded noisy copy of the true F) and
     NeuralNormalLikelihood(3, 6), 300 steps, the loss finite and falling,
     K1 once a step each way, K2 7 times and K3 once a step, no K4 or K5
     (the launches in the kernels line's library_launches), the posterior
     mean's CC with the true F gated (LIBRARY_MIN_CC), its steps/s, device
     time and busy share, and K1, K2 and K3 held at its shapes (the check
     phase also holds this model card against CPU);
  6. the Laue slice (`careless-tpu poly` defaults) at 10,000,000
     observations, 500,000 reflections and 20,000 images on the harmonic-
     chain layout: the host set-up timed step by step, every kernel of the
     step held against its plain version and timed at the step's shapes
     (K1 on the 10M metadata, K2 at each of its nine table and id pairs, K3
     at 10M, K5 at the chain plan's own backward permute; K2 at the image
     cotangent's random 10M permute is a row of the kernels line of its
     own), then 100 steps with K5 launched once per step and K2 nine times;
  7. after every host-time measurement, --save-data-manager and
     --profile-dir (flags_phase): the cli phase's MTZ merged 20 steps by
     `main(["mono", ..., "--save-data-manager", "--profile-dir=DIR"])`,
     the pickle loaded on the card and on the CPU with Inputs bit for bit
     the formatter's, the trace parsed and naming every port kernel the
     run launched, the pickle's and the trace's sizes printed.
The second-to-last line is the card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0), and
without a CUDA device the script exits non-zero before printing a result.
"""
import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import types

import numpy as np

N_OBS, N_REFL, N_IMAGES, D_META, N_LAYERS = 1_000_000, 50_000, 2_000, 10, 20
STEPS, CHUNK = 300, 50   # training steps of the slice phase, steps per chunk
# the Laue slice: BASELINE.md's "chain + streaming windowed kernel" size
LAUE_OBS, LAUE_REFL, LAUE_IMAGES = 10_000_000, 500_000, 20_000
STEPS_LAUE = 100
N_WIDE = 100_000   # observations of the wide trunk checks and rows
# the `wide` slice: --mlp-width 128 (csrc/trunk_wide.cu), its steps and
# steps per chunk
WIDE_SLICE = dict(mlp_width=128)
STEPS_WIDE, CHUNK_WIDE = 20, 10
# csrc/trunk_wide.cu's launchers' host time is taken at this many rows (the
# launch path does not depend on it; few rows keep the queue from filling)
WIDE_HOST_ROWS = 4096
# csrc/trunk_wide.cu's rows at N_WIDE: (d_in, width, layers), from the
# smallest padded width to the JAX kernel's 128 lanes, and a narrow trunk
# whose weights fit in no block
WIDE_ROW_SHAPES = ((10, 33, 20), (64, 64, 20), (10, 128, 20), (128, 128, 20),
                   (10, 32, 64))
# csrc/trunk_wide.cu's device ms per call in its earlier design (64-row
# tiles, 4 x 4 outputs a thread, 4 kw threads a block), at the shapes of its
# rows in the kernels line (the head f32 pair at the `wide` slice's shape,
# the rest at N_WIDE rows, d_in 10, width 128), as this script measured them
# on an NVIDIA H100 80GB HBM3 at 700 W; printed beside this run's times on
# a line of their own, and kept out of the kernels line, which holds only
# what this run measured
EARLIER_WIDE_DEVICE_MS = {
    "trunk_wide_fwd": 25.62, "trunk_wide_bwd": 140.5,
    "trunk_wide_fwd_bf16": 3.321, "trunk_wide_bwd_bf16": 17.09,
    "trunk_wide_only_fwd": 2.590, "trunk_wide_only_bwd": 14.22,
    "trunk_wide_only_fwd_bf16": 3.322, "trunk_wide_only_bwd_bf16": 17.08}
# the Laue step's K2 launch at a random permute of a 10M-entry table, and
# its row in the kernels line
LAUE_PERM_PAIR = "image cotangent by perm"
LAUE_PERM_ROW = "gather_laue_image_perm"
# host_us calls at the Laue shapes: few enough that a device slower than
# the host does not fill the launch queue
LAUE_HOST_CALLS = 300
# K2 launches per step of each slice (the gathers of ops/plan_gather.py);
# "xval" is a frozen-scaler mono step, serial or parallel
GATHERS_PER_STEP = {"default": 7, "a": 14, "b": 14, "image_layers": 3,
                    "bf16": 7, "image_layers_bf16": 3, "laue": 9, "wide": 7,
                    "xval": 4, "library": 7}
# K2 launches of the image scales' backward (the cotangent permute and
# the segment sum's two lookups), which a frozen scaler does not run
IMAGE_BACKWARD_GATHERS = 3

# the mono defaults of the CLI, copied from careless_tpu/args/*.py
MONO_DEFAULTS = dict(
    mc_samples=1, structure_factor_init_scale=1.0, epsilon=1e-7,  # common.py
    freeze_structure_factors=False,                               # common.py
    studentt_likelihood_dof=None, refine_uncertainties=False,     # likelihood.py
    learning_rate=1e-3, beta_1=0.9, beta_2=0.99, clipnorm=None,   # optimizer.py
    clipvalue=None, global_clipnorm=None,                         # optimizer.py
    kl_weight=None, wilson_prior_b=None, parents=None,            # prior.py
    analytic_kl=False, dwr=None, reindexing_ops=None,             # prior.py
    optimize_double_wilson_r=False,                               # prior.py
    freeze_scales=False, mlp_layers=20, mlp_width=None,           # scaling.py
    image_layers=0, use_image_scales=True, scale_bijector="exp",  # scaling.py
    fused_kernel="auto", mlp_dtype="float32",                     # device_options.py
)

# the K1 instantiations (head, bf16), in the order of the kernels line
TRUNK_VARIANTS = ((True, False), (True, True), (False, False), (False, True))
# TPU kernels each CUDA kernel replaces (the pallas_call sites); every K1
# instantiation, narrow or wide, replaces the same two
REPLACES = {
    **{f"{name}_{d}{suffix}": "careless_tpu/ops/fused_mlp.py:"
       + ("175" if d == "fwd" else "190")
       for name in ("trunk", "trunk_only", "trunk_wide", "trunk_wide_only")
       for d in ("fwd", "bwd") for suffix in ("", "_bf16")},
    "gather": "careless_tpu/ops/table_gather.py:125",
    "philox_normal": "careless_tpu/ops/fused_elbo.py:66",
    "fused_ll_fwd": "careless_tpu/ops/fused_elbo.py:291",
    "fused_ll_bwd": "careless_tpu/ops/fused_elbo.py:311",
    "gather_stream": "careless_tpu/ops/table_gather.py:85",
}
# a K1-bwd row's source is the kernel kernels.trunk_route took for its
# shape (the row's `kernel`)
SOURCES = {
    **{k: "careless_tpu_torch/csrc/" + ("trunk_wide.cu" if "wide" in k
                                       else "trunk.cu")
       for k in REPLACES if k.startswith("trunk")},
    "gather": "careless_tpu_torch/csrc/gather.cu",
    "philox_normal": "careless_tpu_torch/csrc/philox.cu",
    "fused_ll_fwd": "careless_tpu_torch/csrc/fused_ll.cu",
    "fused_ll_bwd": "careless_tpu_torch/csrc/fused_ll.cu",
    "gather_stream": "careless_tpu_torch/csrc/gather_stream.cu",
}
# the flag sets of slices (a) and (b) on top of MONO_DEFAULTS
SLICE_A = dict(mc_samples=2)
SLICE_B = dict(mc_samples=2, studentt_likelihood_dof=4.0,
               refine_uncertainties=True)
STEPS_B = 100
# the scaler slices: --image-layers 2 (K1 trunk-only), --mlp-dtype bfloat16
# (K1 bf16) and both (K1 trunk-only bf16), on top of MONO_DEFAULTS
SCALER_SLICES = {"image_layers": dict(image_layers=2),
                 "bf16": dict(mlp_dtype="bfloat16"),
                 "image_layers_bf16": dict(image_layers=2,
                                           mlp_dtype="bfloat16")}
STEPS_SCALER = 100
# Philox and Box-Muller (~40 integer operations, log, sqrt, cos), the chain
# and the likelihood: ~60 operations per observation in K4 (csrc/fused_ll.cu)
K4_OPS_PER_OBS = 60


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(f32 FLOP/s without tensor cores, bytes/s) from NVIDIA's data
    sheets: H100 SXM 67 TFLOP/s and 3.35 TB/s, PCIe 51 and 2.0."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    return 67e12, 3.35e12


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core FLOP/s from NVIDIA's data sheets: H100 SXM
    989 TFLOP/s, PCIe 756."""
    return 756e12 if "PCIe" in name else 989e12


def time_ms(torch, fn, reps=30, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _device_times(torch, fn, reps, attempts=5):
    """{kernel name: device microseconds per call of fn} over `reps` calls,
    from the device-side events of torch.profiler (CUPTI), or None. On the
    card the profiler drops some kernel records of a capture, and now and
    then holds a record from before it or none at all; so each kernel's
    time per call is its mean over the launches captured times its
    launches per call (whole_launches over reps; a stray record rounds to
    0), and a capture without a device event is taken
    again, up to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0
                and whole_launches(e.count, reps)]
        for e in seen:
            CAPTURED["records"] += e.count
            CAPTURED["launches"] += whole_launches(e.count, reps)
        if seen:
            return {e.key: e.self_device_time_total / e.count
                    * whole_launches(e.count, reps) / reps for e in seen}
    return None


def whole_launches(count, calls):
    """The launches that `count` kept profiler records of a kernel stand
    for over `calls` calls that each launch it a whole number of times:
    count rounded to a multiple of calls (0 for fewer than calls / 2)."""
    return calls * round(count / calls)


# kernel records _device_times kept, against the launches they stand for
CAPTURED = {"records": 0, "launches": 0}


def device_ms(torch, fn, reps=30, flush=None):
    """Device time per call of fn: the kernels' own time, summed over the
    device-side events of torch.profiler (CUPTI), without the host's launch
    time that CUDA events around one call also hold when the host is the
    slower side. With `flush`, each call runs after flush() (an L2 flush:
    COLD_L2_BYTES written), and only the kernels that flush() alone does
    not launch are summed, so the flush is not counted. None (not
    measured) where the profiler kept capturing nothing."""
    if flush is None:
        times = _device_times(torch, fn, reps)
        return None if times is None else sum(times.values()) / 1e3
    flush_keys = _device_times(torch, flush, reps)

    def cold():
        flush()
        fn()
    times = _device_times(torch, cold, reps)
    if flush_keys is None or times is None:
        return None
    return sum(t for k, t in times.items() if k not in flush_keys) / 1e3


COLD_L2_BYTES = 128 << 20   # written before each cold call: 2.5x the 50 MB L2


def l2_flush(torch, dev):
    """A function that evicts the card's L2 by writing COLD_L2_BYTES."""
    buf = torch.empty(COLD_L2_BYTES // 4, device=dev)
    return buf.zero_


def host_us(torch, fns, calls=10_000, rounds=10):
    """Host microseconds per call of each of fns ({name: fn}): `calls`
    back-to-back calls of each, timed by time.perf_counter in `rounds`
    rounds that take the functions in turn, so that a host whose speed
    drifts during the run slows them alike; the median round of each. A
    round starts synchronised and its clock stops at the return of its
    last call, before the synchronise, so a device slower than the host
    does not count unless the launch queue fills (the slow rows take few
    enough calls)."""
    per = max(1, calls // rounds)
    for fn in fns.values():
        for _ in range(10):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per):
                fn()
            times[name].append(1e6 * (time.perf_counter() - t0) / per)
    torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def bound(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def own_generator(torch, gen, k: int):
    """A generator on gen's device seeded from gen's seed and k, leaving
    gen's own stream untouched."""
    own = torch.Generator(device=gen.device)
    own.manual_seed(gen.initial_seed() + 1000 * k)
    return own


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def kernel_phase(torch, dev, gen, peak_flops, peak_bw):
    """Hold each kernel against its plain version and time it."""
    n = N_OBS
    launch_path = launch_phase(torch, dev, gen)   # before any profiling
    launchers = k1_k3_host_us(torch, dev, gen)    # the same
    x = torch.randn(n, D_META, generator=gen, device=dev)
    rows = trunk_rows(torch, gen, x, peak_flops, peak_bw)
    # the other K1 instantiations draw from a generator of their own, so
    # that the kernels below see the random inputs of earlier runs
    rows.update(trunk_rows(torch, own_generator(torch, gen, 1), x,
                           peak_flops, peak_bw, variants=TRUNK_VARIANTS[1:]))
    rows.update(wide_kernel_phase(torch, gen, dev, peak_flops, peak_bw))
    for name in ("trunk_fwd", "trunk_bwd", "trunk_wide_fwd",
                 "trunk_wide_bwd"):
        rows[name]["host_us"] = launchers[name]
    # K2: the z_f gather (sorted refl ids) and the image-scale gather
    cases = {}
    for label, size, sort in (("z_f", N_REFL, True),
                              ("image", N_IMAGES, False)):
        ids = torch.randint(0, size, (n,), generator=gen, device=dev)
        if sort:
            ids = torch.sort(ids).values
        cases[label] = gather_row(torch, gen, size, ids.to(torch.int32),
                                  label, peak_flops, peak_bw)
    rows["gather"] = dict(cases["z_f"], launch_path_host_us=launch_path)
    print("gather at the image table (2,000 entries, unsorted ids): "
          + json.dumps(cases["image"]))
    rows["philox_normal"] = philox_row(torch, dev, gen, n, 3 * n, peak_flops,
                                       peak_bw)
    rows["philox_normal"].update(host_us=launchers["philox_normal"],
                                 library_host_us=launchers["randn"])
    from careless_tpu_torch import kernels
    rows["philox_normal"]["stats"] = prng_gate(torch, kernels, dev)
    rows.update(fused_ll_phase(torch, dev, gen, peak_flops, peak_bw))
    for name, key in K4_HOST.items():
        rows[name]["host_us"] = launch_path[key]
    return rows


def random_trunk(torch, gen, d, w, n_layers, dev):
    """An n_layers-deep trunk of width w over d columns (identity plus
    noise, so every layer matters) and its head, as leaves needing grad."""
    layers = []
    for i in range(n_layers):
        d_in = d if i == 0 else w
        layers.append({
            "w": (torch.eye(d_in, w, device=dev) + 0.1 / math.sqrt(w)
                  * torch.randn(d_in, w, generator=gen, device=dev)
                  ).requires_grad_(True),
            "b": (0.05 * torch.randn(w, generator=gen, device=dev)
                  ).requires_grad_(True)})
    out = {"w": (torch.randn(w, 2, generator=gen, device=dev) / math.sqrt(w)
                 ).requires_grad_(True),
           "b": torch.zeros(2, device=dev).requires_grad_(True)}
    return layers, out


def trunk_rows(torch, gen, x, peak_flops, peak_bw, variants=((True, False),),
               n_layers=N_LAYERS, width=None, reps=30, backward=True):
    """K1-fwd and K1-bwd on metadata x (N, d) for each (head, bf16)
    instantiation in `variants`: a random n_layers-deep trunk of `width`
    (default d), held against the plain version (the bf16 plain version
    for bf16) at 1e-4 of the output scale and of each gradient tensor's
    largest entry (20 layers summed in another order than cuBLAS), dW
    bitwise repeatable, timed beside the plain version; returns the kernel
    rows by LAUNCHES name (csrc/trunk_wide.cu's names where
    kernels.trunk_route takes it). Bounds: f32 rows at the f32 peak; bf16
    rows at the bf16 tensor-core peak (the least time for bf16 products);
    the trunk-only rows move (N, width) activations and cotangents. Each
    backward row names the kernel kernels.trunk_route took and its
    tile; where that is csrc/trunk_bwd.cu (f32) or csrc/trunk_bwd_bf16.cu
    (bf16), the row also times csrc/trunk.cu's backward, with the same
    bf16 flag, on the same inputs (trunk_cu_device_ms, trunk_cu_ms) and
    gives its largest difference from the routed kernel. backward=False
    holds the forward only (a frozen scaler's path)."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_mlp import (
        fused_mlp_trunk, fused_mlp_trunk_head, pack_params, plain_trunk,
        plain_trunk_head)

    rows = {}
    dev = x.device
    (n, d), L = x.shape, n_layers
    w = width or d
    layers, out = random_trunk(torch, gen, d, w, L, dev)
    ops_peak = {False: peak_flops,
                True: bf16_peak(torch.cuda.get_device_name(dev))}
    for head, bf16 in variants:
        route = kernels.trunk_route(d, w, L, head, bf16)
        kw, wide = route.width, kernels.TRUNK_WIDE
        fwd, bwd = (kernels.trunk_key(k, head, bf16, wide=kernel == wide)
                    for k, kernel in (("fwd", route.fwd),
                                      ("bwd", route.bwd)))
        fwd_fn = (kernels.trunk_wide_fwd if route.fwd == wide
                  else kernels.trunk_fwd)
        bwd_fn = (kernels.trunk_wide_bwd if route.bwd == wide
                  else kernels.trunk_bwd)
        leaves = [t for layer in layers for t in (layer["w"], layer["b"])]
        if head:
            def kern(x):
                return fused_mlp_trunk_head(x, layers, out, 0.01, bf16=bf16)

            def plain(x):
                return plain_trunk_head(x, layers, out, 0.01, bf16=bf16)
            leaves += [out["w"], out["b"]]
            cts = (torch.randn(n, generator=gen, device=dev),
                   torch.randn(n, generator=gen, device=dev))
        else:
            def kern(x):
                return (fused_mlp_trunk(x, layers, 0.01, bf16=bf16),)

            def plain(x):
                return (plain_trunk(x, layers, 0.01, bf16=bf16),)
            cts = (torch.randn(n, w, generator=gen, device=dev),)
        n_out = sum(c.numel() for c in cts)
        F = d * w + (L - 1) * w * w + (2 * w if head else 0)
        nb = L * w + (2 if head else 0)

        # K1-fwd
        with torch.no_grad():
            ys_k, ys_p = kern(x), plain(x)
        scale = max(max(y.abs().max().item() for y in ys_p), 1.0)
        err = max((a - b).abs().max().item() for a, b in zip(ys_k, ys_p))
        del ys_k, ys_p
        tol = 1e-4 * scale
        check(err <= tol, f"{fwd} at N = {n}, width {w}, differs from "
              f"plain: {err} > {tol}")
        wflat, bflat = (t.detach() for t in pack_params(
            layers, out if head else None, kw))
        cfg = dict(head=head, bf16=bf16)
        if not head:
            cfg["out_w"] = w
        with torch.no_grad():
            ms = time_ms(torch, lambda: fwd_fn(
                x, wflat, bflat, kw, L, 0.01, **cfg), reps=reps)
            plain_ms = time_ms(torch, lambda: plain(x), reps=reps)
            d_ms = device_ms(torch, lambda: fwd_fn(
                x, wflat, bflat, kw, L, 0.01, **cfg), reps=reps)
        b_ms, b_by = bound(2.0 * n * F, 4.0 * (n * d + n_out + F + nb),
                           ops_peak[bf16], peak_bw)
        rows[fwd] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                         device_ms=d_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, n=n, d_in=d,
                         width=w, n_layers=L)
        if not backward:
            continue

        # K1-bwd through autograd, against autograd of the plain version
        def grads(fn):
            obj = sum((y * c).sum() for y, c in zip(fn(x), cts))
            return torch.autograd.grad(obj, leaves)
        g_k = grads(kern)
        g_k2 = grads(kern)
        g_p = grads(plain)
        check(all(torch.equal(a, b) for a, b in zip(g_k, g_k2)),
              f"{bwd} at N = {n}, width {w}, is not bitwise repeatable")
        err = max((a - b).abs().max().item() for a, b in zip(g_k, g_p))
        gscale = max(b.abs().max().item() for b in g_p)
        tol = 1e-4 * gscale  # sums over N observations in another order
        check(err <= tol, f"{bwd} at N = {n}, width {w}, differs from "
              f"plain: {err} > {tol}")
        dy = cts if head else cts[0]
        ms = time_ms(torch, lambda: bwd_fn(
            x, wflat, bflat, dy, kw, L, 0.01, False, head=head, bf16=bf16),
            reps=reps)
        obj = sum((y * c).sum() for y, c in zip(plain(x), cts))
        plain_ms = time_ms(torch, lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True), reps=reps)
        del obj
        b_ms, b_by = bound(2.0 * n * (3 * F - d * w),
                           4.0 * (n * d + n_out + 2 * (F + nb)),
                           ops_peak[bf16], peak_bw)
        d_ms = device_ms(torch, lambda: bwd_fn(
            x, wflat, bflat, dy, kw, L, 0.01, False, head=head, bf16=bf16),
            reps=reps)
        rows[bwd] = dict(max_abs_err=err, tolerance=tol, ms=ms,
                         device_ms=d_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None,
                         bitwise_repeatable=True, n=n, d_in=d, width=w,
                         n_layers=L, kernel=route.bwd, tile=route.tile)
        if route.bwd in (kernels.TRUNK_BWD_F32, kernels.TRUNK_BWD_BF16):
            general = general_bwd(torch, x, wflat, bflat, dy, kw, L, head,
                                  bf16)
            mine = torch.cat(kernels.trunk_bwd(x, wflat, bflat, dy, kw, L,
                                               0.01, False, head=head,
                                               bf16=bf16)[:2])
            rows[bwd].update(
                trunk_cu_tile=kernels.trunk_bwd_tile(d, kw, L, head),
                trunk_cu_ms=time_ms(torch, general, reps=reps),
                trunk_cu_device_ms=device_ms(torch, general, reps=reps),
                trunk_cu_max_abs_diff=(general() - mine).abs().max().item())
            del mine
    return rows


def general_bwd(torch, x, wflat, bflat, dy, kw, n_layers, head, bf16):
    """A function that launches csrc/trunk.cu's backward (the kernel every
    K1-bwd ran on before csrc/trunk_bwd.cu and csrc/trunk_bwd_bf16.cu) on
    these inputs with the bf16 flag given, as kernels.trunk_bwd would at
    its tile, without counting a launch; the function returns the
    (nw + nb) output, [dW flat, db flat]."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.kernels._build import library

    (n, d), idx = x.shape, x.get_device()
    tile = kernels.trunk_bwd_tile(d, kw, n_layers, head)
    n_blocks = kernels._trunk_bwd_blocks(
        n, kernels.trunk_smem(d, kw, n_layers, head, tile), tile, idx)
    dys = dy if head else (dy,)
    size = wflat.numel() + bflat.numel()
    part = torch.empty((n_blocks, size), device=x.device)
    out = torch.empty(size, device=x.device)
    args = (x.data_ptr(), wflat.data_ptr(), bflat.data_ptr(),
            dys[0].data_ptr(), dys[1].data_ptr() if head else None, None,
            part.data_ptr(), out.data_ptr(), n, d, kw, n_layers, int(head),
            0 if head else dy.shape[1], int(bf16), tile, n_blocks, 0.01)

    def run():
        err = library().ct_trunk_bwd(
            *args, torch._C._cuda_getCurrentRawStream(idx))
        check(err == 0, f"csrc/trunk.cu's backward refused: CUDA error {err}")
        return out
    return run


def wide_trunk_phase(torch, gen, dev, peak_flops, peak_bw):
    """K1 (head, f32) at 20 layers of width 28 over 28 columns and of
    width 32 over 128, which a 64-row backward tile cannot hold: held
    against the plain version and timed as trunk_rows does, at
    N_WIDE observations so that the short-tile backward stays quick."""
    out = {}
    gen = own_generator(torch, gen, 2)
    for d, w in ((28, 28), (128, 32)):
        x = torch.randn(N_WIDE, d, generator=gen, device=dev)
        rows = trunk_rows(torch, gen, x, peak_flops, peak_bw, width=w,
                          reps=10)
        out[f"width {w}, d_in {d}"] = rows
        print(f"trunk at width {w}, d_in {d}, {N_LAYERS} layers: "
              + json.dumps(rows), flush=True)
    return out


def wide_kernel_phase(torch, gen, dev, peak_flops, peak_bw):
    """csrc/trunk_wide.cu: its four instantiations at WIDE_ROW_SHAPES
    (N_WIDE rows, so that the plain version's activations stay small), held
    against the plain version and timed as trunk_rows does; its forward
    bit for bit csrc/trunk.cu's at a shape both take (width 32 over d_in
    32, 20 layers, head, f32 and bf16) and its backward's dW and db bit for
    bit the same from two calls; its forward bit for bit csrc/trunk.cu's
    at the main path's shape (N_OBS rows, d = w = D_META, N_LAYERS layers,
    the four instantiations); then the head f32 row at the `wide`
    slice's shape (N_OBS rows, d_in D_META, width 128, N_LAYERS layers).
    Returns the kernel rows of the kernels line: the head f32 pair at the
    slice's shape, the other instantiations at width 128 over d_in 10."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_mlp import pack_params

    gen = own_generator(torch, gen, 3)
    table = {}
    for d, w, n_layers in WIDE_ROW_SHAPES:
        x = torch.randn(N_WIDE, d, generator=gen, device=dev)
        rows = trunk_rows(torch, gen, x, peak_flops, peak_bw,
                          variants=TRUNK_VARIANTS, n_layers=n_layers,
                          width=w, reps=10)
        for name, row in rows.items():
            check("wide" in name, f"{name} at width {w}, d_in {d}, "
                  f"{n_layers} layers did not take csrc/trunk_wide.cu")
        if (d, w) == (10, 128):
            table.update(rows)
        print(f"trunk_wide at width {w}, d_in {d}, {n_layers} layers, "
              f"N = {N_WIDE}: " + json.dumps(rows), flush=True)
        del x

    x = torch.randn(N_WIDE, 32, generator=gen, device=dev)
    layers, out = random_trunk(torch, gen, 32, 32, N_LAYERS, dev)
    wflat, bflat = (t.detach() for t in pack_params(layers, out, 32))
    dy = (torch.randn(N_WIDE, generator=gen, device=dev),
          torch.randn(N_WIDE, generator=gen, device=dev))
    for bf16 in (False, True):
        narrow = kernels.trunk_fwd(x, wflat, bflat, 32, N_LAYERS, 0.01,
                                   bf16=bf16)
        wide = kernels.trunk_wide_fwd(x, wflat, bflat, 32, N_LAYERS, 0.01,
                                      bf16=bf16)
        check(all(torch.equal(a, b) for a, b in zip(narrow, wide)),
              f"trunk_wide's forward (bf16 {bf16}) is not trunk.cu's bit "
              "for bit at width 32 over d_in 32")
        grads = [torch.cat(kernels.trunk_wide_bwd(
            x, wflat, bflat, dy, 32, N_LAYERS, 0.01, False, bf16=bf16)[:2])
            for _ in range(2)]
        check(torch.equal(*grads), f"trunk_wide's backward (bf16 {bf16}) "
              "dW and db differ between two calls")
    print(f"trunk_wide at width 32 over d_in 32, {N_LAYERS} layers, "
          f"N = {N_WIDE}: forward bit for bit csrc/trunk.cu's, backward "
          "dW and db bit for bit repeatable, f32 and bf16", flush=True)
    del x, dy

    # the main path's shape: csrc/trunk.cu's forward at width D_META and
    # the wide one on the same trunk packed at 16 (zero-padded products add
    # exact zeros), in the four instantiations
    x = torch.randn(N_OBS, D_META, generator=gen, device=dev)
    layers, out = random_trunk(torch, gen, D_META, D_META, N_LAYERS, dev)
    wide_w = kernels.WIDE_STEP
    for head, bf16 in TRUNK_VARIANTS:
        cfg = dict(head=head, bf16=bf16, out_w=None if head else D_META)
        narrow = kernels.trunk_fwd(x, *(t.detach() for t in pack_params(
            layers, out if head else None, D_META)), D_META, N_LAYERS, 0.01,
            **cfg)
        wide = kernels.trunk_wide_fwd(x, *(t.detach() for t in pack_params(
            layers, out if head else None, wide_w)), wide_w, N_LAYERS, 0.01,
            **cfg)
        check(all(torch.equal(a, b) for a, b in zip(
            narrow if head else (narrow,), wide if head else (wide,))),
            f"csrc/trunk.cu's forward (head {head}, bf16 {bf16}) is not "
            f"trunk_wide's bit for bit at the main path's shape")
    print(f"trunk.cu's forward at N = {N_OBS}, d = w = {D_META}, {N_LAYERS} "
          f"layers: bit for bit trunk_wide's (packed at {wide_w}), head or "
          "trunk only, f32 and bf16", flush=True)
    del x, narrow, wide

    x = torch.randn(N_OBS, D_META, generator=gen, device=dev)
    rows = trunk_rows(torch, gen, x, peak_flops, peak_bw,
                      width=WIDE_SLICE["mlp_width"], reps=10)
    print("trunk_wide at the wide slice's shape: " + json.dumps(rows),
          flush=True)
    table.update(rows)
    print("trunk_wide device ms, this run against the earlier design's "
          "(constants, not measured in this run): " + json.dumps(
              {name: {"device_ms": row["ms"],
                      "earlier_device_ms": EARLIER_WIDE_DEVICE_MS[name]}
               for name, row in table.items()}), flush=True)
    return table


def gather_timings(torch, fns, flush, calls):
    """For each of `fns` ({prefix: fn}, the kernel under "" and
    index_select under "library_"): host microseconds per call (host_us,
    all of fns in turn), device milliseconds per call with a warm L2
    (device_ms) and after an L2 flush (cold_device_ms)."""
    out = {prefix + "host_us": us
           for prefix, us in host_us(torch, fns, calls).items()}
    for prefix, fn in fns.items():
        out[prefix + "device_ms"] = device_ms(torch, fn)
        out[prefix + "cold_device_ms"] = device_ms(torch, fn, flush=flush)
    return out


def gather_row(torch, gen, size, ids, label, peak_flops, peak_bw,
               calls=10_000):
    """K2 over a random table of `size` entries by the int32 `ids`, held
    bit for bit against its plain version and index_select, and timed
    beside them: CUDA events (ms), host time per call over `calls`
    back-to-back calls (host_us), device time warm and after an L2 flush,
    for K2 and for index_select; returns its kernel row."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.table_gather import plain_gather, table_gather

    table = torch.randn(size, generator=gen, device=ids.device)
    got = table_gather(table, ids)
    err = (got - plain_gather(table, ids)).abs().max().item()
    check(err == 0.0 and torch.equal(got, torch.index_select(table, 0, ids)),
          f"gather ({label}) differs from plain or index_select: {err}")
    del got
    b_ms, b_by = bound(0.0, 4.0 * (2 * ids.numel() + size), peak_flops,
                       peak_bw)
    timed = gather_timings(
        torch, {"": lambda: kernels.gather(table, ids),
                "library_": lambda: torch.index_select(table, 0, ids)},
        l2_flush(torch, ids.device), calls)
    return dict(
        max_abs_err=err, tolerance=0.0,
        ms=time_ms(torch, lambda: kernels.gather(table, ids)),
        plain_ms=time_ms(torch, lambda: plain_gather(table, ids)),
        library_ms=time_ms(torch, lambda: torch.index_select(table, 0, ids)),
        **timed, host_calls=calls, bound_ms=b_ms, bound_by=b_by, table=size,
        n_ids=ids.numel())


def launch_phase(torch, dev, gen, steps=True, calls=10_000):
    """Host time of the gathers' launches, by host_us (less an empty call's
    time), before the run's first profiler capture: profiling leaves
    PyTorch's own calls in the process slower (PERF.md §6), so the
    gathers' rows, measured later, compare kernel and index_select only
    with each other. At the mono z_f shape (1M sorted ids into 50k
    entries): K2's launcher whole and index_select, and with `steps` each
    step of a K2 launch alone, those the launcher took on every call before
    it relied on its plans (two dtype/device/contiguity checks, the
    device context, torch.cuda.current_stream, an
    output sized by ids.shape) beside those it takes now (one expression of
    cheap checks, torch.cuda.current_device, the raw stream handle, an
    output sized by an int), and the ctypes call, which launches. At the
    300k swap permutation (swap_windows): K5's launcher whole beside
    index_select and K2 on its flat ids. K4's two launchers whole at
    slice (a)'s shape (K4_HOST names them). Draws from a generator of its own
    seeded from gen's seed."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.kernels._build import library

    gen = own_generator(torch, gen, 3)
    table = torch.randn(N_REFL, generator=gen, device=dev)
    ids = torch.sort(torch.randint(0, N_REFL, (N_OBS,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    perm, ids2d, bases, window = swap_windows(torch, dev)
    x = torch.randn(perm.shape[0], generator=gen, device=dev)
    flat = ids2d.reshape(-1)
    out = torch.empty(N_OBS, device=dev)
    ct_gather, idx = library().ct_gather, dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    f32, i32 = torch.float32, torch.int32

    def context():
        with torch.cuda.device(dev):
            pass

    def require(t, name, dtype):
        # the check the launchers made of each tensor before they relied on
        # their plans
        if (dev.type != "cuda" or t.device != dev or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")

    def checks():
        return (table.dtype is not f32 or ids.dtype is not i32
                or table.get_device() < 0 or ids.get_device() != idx
                or not table.is_contiguous() or not ids.is_contiguous())

    fns = {
        "K2 launcher, whole": lambda: kernels.gather(table, ids),
        "index_select": lambda: torch.index_select(table, 0, ids),
        "K5 launcher at the swap permutation, whole": lambda:
            kernels.gather_stream(x, ids2d, bases, window, 64),
        "index_select at the swap permutation": lambda:
            torch.index_select(x, 0, flat),
        "K2 launcher at the swap permutation": lambda:
            kernels.gather(x, flat),
    }
    if steps:
        fns.update({
            "before: one dtype/device/contiguity check (two per call)":
                lambda: require(ids, "ids", i32),
            "before: torch.cuda.device context": context,
            "before: torch.cuda.current_stream(dev).cuda_stream":
                lambda: torch.cuda.current_stream(dev).cuda_stream,
            "before: torch.empty of the output, sized by ids.shape": lambda:
                torch.empty(ids.shape, dtype=f32, device=dev),
            "now: type, device and contiguity checks": checks,
            "now: torch.cuda.current_device()": torch.cuda.current_device,
            "now: torch._C._cuda_getCurrentRawStream": lambda:
                torch._C._cuda_getCurrentRawStream(idx),
            "now: torch.empty of the output, sized by an int": lambda:
                torch.empty(N_OBS, dtype=f32, device=dev),
            "both: three data_ptr() calls": lambda: (
                table.data_ptr(), ids.data_ptr(), out.data_ptr()),
            "both: the ctypes call, which launches": lambda: ct_gather(
                table.data_ptr(), ids.data_ptr(), out.data_ptr(), N_OBS,
                stream)})
    timed = host_us(torch, {"empty call (subtracted)": lambda: None, **fns},
                    calls)
    empty = timed["empty call (subtracted)"]
    out_us = {k: v - empty for k, v in timed.items() if k in fns}
    out_us["empty call (subtracted)"] = empty
    # K4's launchers at slice (a)'s shape, in-kernel normals, kind normal;
    # K1_HOST_CALLS calls, so that its device time never fills the queue
    args = k4_inputs(torch, gen, N_OBS, dev)
    ev = torch.tensor([1.3, 0.2, 0.7], device=dev)
    ct = torch.tensor(0.75, device=dev)
    cfg = dict(kind="normal", dof=0.0, t_const=0.0, seed=7, offset=N_OBS)
    k4 = host_us(torch, {
        K4_HOST["fused_ll_fwd"]: lambda: kernels.fused_ll_fwd(
            *args, None, None, ev, **cfg),
        K4_HOST["fused_ll_bwd"]: lambda: kernels.fused_ll_bwd(
            *args, None, None, ev, ct, **cfg)}, K1_HOST_CALLS)
    out_us.update({k: v - empty for k, v in k4.items()})
    print(("gather launch path" if steps else "gather launches again, after "
           "the run's profiler captures") + ", host us per call: "
          + json.dumps(out_us), flush=True)
    return out_us


K1_HOST_CALLS = 300   # K1 launches per host_us: the queue never fills
# launch_phase's names of K4's launchers, by kernel
K4_HOST = {"fused_ll_fwd": "K4-fwd launcher, whole (1M, kind normal)",
           "fused_ll_bwd": "K4-bwd launcher, whole (1M, kind normal)"}


def k1_k3_host_us(torch, dev, gen):
    """Host microseconds per call of the K1 and K3 launchers at the main
    path's shapes (chip_smoke's host_us; call before any profiler capture,
    as launch_phase): K1-fwd and K1-bwd (f32, head) at N_OBS observations
    of D_META columns over N_LAYERS layers of width D_META, K1_HOST_CALLS
    calls each; csrc/trunk_wide.cu's (f32, head) at WIDE_HOST_ROWS rows and
    the `wide` slice's width, K1_HOST_CALLS calls each; K3 for N_OBS
    normals beside torch.randn, 10,000 calls each. Draws from a generator
    of its own seeded from gen's seed."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_mlp import pack_params

    gen = own_generator(torch, gen, 4)
    x = torch.randn(N_OBS, D_META, generator=gen, device=dev)
    layers, out = random_trunk(torch, gen, D_META, D_META, N_LAYERS, dev)
    w, b = (t.detach() for t in pack_params(layers, out, D_META))
    dy = (torch.randn(N_OBS, generator=gen, device=dev),
          torch.randn(N_OBS, generator=gen, device=dev))
    k1 = host_us(torch, {
        "trunk_fwd": lambda: kernels.trunk_fwd(x, w, b, D_META, N_LAYERS,
                                               0.01),
        "trunk_bwd": lambda: kernels.trunk_bwd(x, w, b, dy, D_META,
                                               N_LAYERS, 0.01, False)},
        calls=K1_HOST_CALLS)
    w_in = WIDE_SLICE["mlp_width"]
    xw = torch.randn(WIDE_HOST_ROWS, D_META, generator=gen, device=dev)
    layers, out = random_trunk(torch, gen, D_META, w_in, N_LAYERS, dev)
    ww, bw = (t.detach() for t in pack_params(layers, out, w_in))
    dyw = (torch.randn(WIDE_HOST_ROWS, generator=gen, device=dev),
           torch.randn(WIDE_HOST_ROWS, generator=gen, device=dev))
    wide = host_us(torch, {
        "trunk_wide_fwd": lambda: kernels.trunk_wide_fwd(
            xw, ww, bw, w_in, N_LAYERS, 0.01),
        "trunk_wide_bwd": lambda: kernels.trunk_wide_bwd(
            xw, ww, bw, dyw, w_in, N_LAYERS, 0.01, False)},
        calls=K1_HOST_CALLS)
    k3 = host_us(torch, {
        "philox_normal": lambda: kernels.philox_normal(N_OBS, 7, 0, dev),
        "randn": lambda: torch.randn(N_OBS, generator=gen, device=dev)})
    out = {**k1, **wide, **k3}
    print("K1 and K3 launchers, host us per call, before any profiler "
          "capture: " + json.dumps(out), flush=True)
    return out


def philox_row(torch, dev, gen, n, offset, peak_flops, peak_bw):
    """K3 for n normals of indices offset .. offset + n - 1, and again at
    offset + 1 (a range that starts and ends inside a Philox block): raw
    words bitwise, normals within a few ulp of the plain version; timed
    beside it and randn (CUDA events, and device time warm for both);
    returns its kernel row."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_elbo import plain_prng_normal

    seed = 0x1234567890ABCDEF
    tol = 2e-5  # log/sqrt/sincos may round differently; |x| <= 5.8
    err = 0.0
    for at in (offset, offset + 1):
        e_k, bits_k = kernels.philox_normal(n, seed, at, dev, with_bits=True)
        e_p, bits_p = plain_prng_normal(n, seed, at, dev, with_bits=True)
        check(torch.equal(bits_k, bits_p),
              f"philox words at n = {n}, offset {at} differ from plain")
        err = max(err, (e_k - e_p).abs().max().item())
        del e_k, bits_k, e_p, bits_p
    check(err <= tol, f"philox normals at n = {n} differ from plain: {err} "
          f"> {tol}")
    b_ms, b_by = bound(0.0, 4.0 * n, peak_flops, peak_bw)
    return dict(
        max_abs_err=err, tolerance=tol,
        ms=time_ms(torch, lambda: kernels.philox_normal(n, seed, 0, dev)),
        device_ms=device_ms(torch, lambda: kernels.philox_normal(n, seed, 0,
                                                                 dev)),
        plain_ms=time_ms(torch, lambda: plain_prng_normal(n, seed, 0, dev),
                         reps=20),
        library_ms=time_ms(torch, lambda: torch.randn(n, generator=gen,
                                                      device=dev)),
        library_device_ms=device_ms(torch, lambda: torch.randn(
            n, generator=gen, device=dev)),
        bound_ms=b_ms, bound_by=b_by)


def k4_inputs(torch, gen, n, dev):
    """K4's inputs (loc, scale, a, f, iobs, sig) for n observations, drawn
    from gen: loc ~ 1 + 0.3 N(0, 1), scale in [0.05, 0.3), a ~ +-(1 + 0.1
    N(0, 1)) with 5 % negative, f in [0.3, 2.5), iobs ~ f^2 (1 + 0.2
    N(0, 1)), sig in [0.1, 1.0): at sig 0.1 and f 2.5 a Student-t
    gradient is most sensitive to the rounding of ipred."""
    f = 0.3 + 2.2 * torch.rand(n, generator=gen, device=dev)
    return [1.0 + 0.3 * torch.randn(n, generator=gen, device=dev),   # loc
            0.05 + 0.25 * torch.rand(n, generator=gen, device=dev),  # scale
            torch.where(torch.rand(n, generator=gen, device=dev) < 0.05,
                        -1.0, 1.0)
            * (1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)),  # a
            f,
            f * f * (1.0 + 0.2 * torch.randn(n, generator=gen,
                                             device=dev)),          # iobs
            0.1 + 0.9 * torch.rand(n, generator=gen, device=dev)]    # sig


IPRED_ULPS = 4   # ulps of ipred the two versions' roundings may differ by
# the generators of studentt_settle, and the one of the card test
# (tests/test_torch_cuda.py): at seed 0 with supplied noise the studentt
# dloc differs from the plain version by 6.6e-4, past 1e-5 of its largest
# entry (1.16 times that)
STUDENTT_SEEDS = tuple(range(8))
STUDENTT_TEST_SEED = 0


def studentt_check(torch, args, ev, eps, eps_kernel, ct, kind, dof, got,
                   ref, label):
    """K4-bwd's four gradients of a Student-t kind (got) against their
    plain version (ref), held per observation; raises past the bound.

    Why not 1e-5 of each tensor's largest entry, as for the other kinds:
    the kernel rounds ipred = (a loc + |a| scale eps) f^2 with fused
    multiply-adds where the plain version rounds every step, so the two
    ipred differ by a few ulp; a Student-t d ll / d ipred is steep near
    r = 0 (slope -(dof + 1) / (dof s^2), -125 at dof 4 and s = 0.1) and
    flat at its largest value (r = sqrt(dof)), so a few ulp of ipred at
    f = 2.5 move dloc by ~3e-4 where 1e-5 of its largest entry is ~6.5e-4.
    The bound per observation and gradient X = ct g m_X (g = d ll / d
    ipred, m_X its multiplier: a f^2, |a| eps f^2, (loc + sign(a) scale
    eps) f^2, 2 z f) is |ct| |dg/dipred| delta |m_X| + 1e-5 max|X|, with
    dg/dipred from autograd in f64 and delta = IPRED_ULPS 2^-23 (|a loc| +
    |a scale eps|) f^2 (ulps of the terms, which a cancelling z can hide),
    plus |a| scale |eps_kernel - eps| f^2 where the kernel draws its own
    normals (K3's words, normals within a few ulp of the plain version's).
    Also held: the kernel is no farther from the f64 gradient (computed
    from the same f32 inputs) than the plain version is, plus that bound.
    Returns the largest ratios: old (|got - ref| over 1e-5 max|ref|), new
    (over the bound), f64 (the kernel's excess over the plain version's
    f64 error, over the bound) and the worst dloc entries."""
    from careless_tpu_torch.ops.fused_elbo import pointwise_grads

    loc, scale, a, f, iobs, sig = (t.double() for t in args)
    e = eps.double()
    z = a * loc + a.abs() * scale * e
    ipred = (z * f * f).requires_grad_(True)
    g, _ = pointwise_grads(kind, dof, ev.double(), iobs, sig, ipred)
    (slope,) = torch.autograd.grad(g.sum(), ipred)
    g = g.detach()
    delta = IPRED_ULPS * 2.0 ** -23 * ((a * loc).abs()
                                       + (a * scale * e).abs()) * f * f
    if eps_kernel is not None:
        delta = delta + a.abs() * scale * (eps_kernel.double() - e).abs() \
            * f * f
    w = float(ct)
    mults = (a * f * f, a.abs() * e * f * f,
             (loc + torch.sign(a) * scale * e) * f * f, 2.0 * z * f)
    out = dict(old=0.0, new=0.0, f64=0.0)
    for name, m, k, p in zip(("dloc", "dscale", "da", "df"), mults, got, ref):
        exact = w * g * m
        bnd = abs(w) * slope.abs() * delta * m.abs() \
            + 1e-5 * exact.abs().max()
        diff = (k.double() - p.double()).abs()
        excess = (k.double() - exact).abs() - (p.double() - exact).abs()
        new, f64 = (diff / bnd).max().item(), (excess / bnd).max().item()
        check(new <= 1.0 and f64 <= 1.0,
              f"fused_ll_bwd {kind} {name} ({label}): past the ipred "
              f"rounding bound: |kernel - plain| {new:.3g} and kernel's "
              f"excess f64 error {f64:.3g} times the bound")
        out["old"] = max(out["old"], diff.max().item()
                         / (1e-5 * p.abs().max().item()))
        out["new"], out["f64"] = max(out["new"], new), max(out["f64"], f64)
        if name == "dloc":
            top = torch.topk(diff, 3).indices
            out["worst_dloc"] = [dict(
                ipred=ipred[i].item(), f=f[i].item(), sig=sig[i].item(),
                r_at_sig=((iobs[i] - ipred[i]) / sig[i]).item(),
                kernel=k[i].item(), plain=p[i].item(),
                f64=exact[i].item(), bound=bnd[i].item()) for i in top]
    return out


def studentt_settle(torch, dev, seeds=STUDENTT_SEEDS):
    """K4-bwd's Student-t kinds at N = 1M on k4_inputs from a generator of
    each seed, with supplied noise and with the kernel's own normals, held
    by studentt_check; returns the largest ratios per kind and seed."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_elbo import (
        plain_fused_likelihood_grads, plain_prng_normal, studentt_log_norm)

    n = N_OBS
    key, offset = 0x0FEDCBA987654321, n
    ev = torch.tensor([1.3, 0.2, 0.7], device=dev)
    ct = torch.tensor(0.75, device=dev)
    eps_k3 = kernels.philox_normal(n, key, offset, dev)
    eps_plain = plain_prng_normal(n, key, offset, dev)
    found = {}
    for s in seeds:
        gen = torch.Generator(device=dev).manual_seed(s)
        args = k4_inputs(torch, gen, n, dev)
        noise = torch.randn(n, generator=gen, device=dev)
        for kind in ("studentt", "studentt_ev11"):
            cfg = dict(kind=kind, dof=4.0, seed=key, offset=offset,
                       t_const=studentt_log_norm(4.0))
            for supplied in (noise, None):
                eps = noise if supplied is not None else eps_plain
                got = kernels.fused_ll_bwd(*args, None, supplied, ev, ct,
                                           **cfg)
                ref = plain_fused_likelihood_grads(*args, None, ev, eps, ct,
                                                   kind=kind, dof=4.0)
                label = (f"seed {s}, "
                         + ("noise" if supplied is not None else "philox"))
                found[f"{kind}, {label}"] = studentt_check(
                    torch, args, ev, eps,
                    None if supplied is not None else eps_k3, ct, kind, 4.0,
                    got[:4], ref[:4], label)
    print("K4-bwd Student-t against the ipred rounding bound: "
          + json.dumps(found), flush=True)
    return {k: {r: v[r] for r in ("old", "new", "f64")}
            for k, v in found.items()}


def fused_ll_phase(torch, dev, gen, peak_flops, peak_bw):
    """K4-fwd and K4-bwd at N = 1M for all five kinds, with and without
    supplied noise, against their plain versions; the in-kernel normals
    against K3's (bitwise); the forward again at an offset that is not a
    multiple of 4 (normal and studentt_ev11); times for the normal kind (slice (a)) and the
    studentt_ev11 kind (slice (b)). Tolerances, with the reason: the sum
    within 1e-5 of the sum of |mask ll| (f32 sums over 1M terms in another
    order); each per-observation gradient within 1e-5 of its tensor's
    largest entry (the kernel fuses multiply-adds where the plain version
    rounds each step, and da = dz loc + sign(a) scale eps dz cancels),
    except Laplace's where |iobs - ipred| is within 1e-5 of their size (its
    gradient jumps there, and the two versions may land on either side),
    and the Student-t kinds', held per observation within the rounding of
    ipred (studentt_check says why, and holds the kernel against f64; at
    other inputs, such as studentt_settle's seeds, 1e-5 of the largest
    entry is exceeded by rounding alone); the Ev11 sums within 1e-5 of the
    sum of their terms' magnitudes."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_elbo import (
        plain_fused_likelihood_grads, plain_fused_likelihood_sum,
        plain_prng_normal, pointwise_grads, pointwise_ll, studentt_log_norm)

    n = N_OBS
    seed, offset = 0x0FEDCBA987654321, n     # sample 1 of a step
    args = k4_inputs(torch, gen, n, dev)
    ev = torch.tensor([1.3, 0.2, 0.7], device=dev)
    noise = torch.randn(n, generator=gen, device=dev)
    eps_k3 = kernels.philox_normal(n, seed, offset, dev)
    eps_plain = plain_prng_normal(n, seed, offset, dev)
    ct = torch.tensor(0.75, device=dev)
    kinds = (("normal", 0.0), ("studentt", 4.0), ("laplace", 0.0),
             ("normal_ev11", 0.0), ("studentt_ev11", 4.0))
    err_fwd = err_bwd = 0.0
    jumps = 0
    for kind, dof in kinds:
        cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
                   t_const=studentt_log_norm(dof) if dof else 0.0)
        for supplied in (noise, None):
            eps = noise if supplied is not None else eps_plain
            out = kernels.fused_ll_fwd(*args, None, supplied, ev, **cfg)
            want = plain_fused_likelihood_sum(*args, None, ev, eps,
                                              kind=kind, dof=dof)
            ipred = (args[2] * args[0] + args[2].abs() * args[1] * eps) \
                * args[3] * args[3]
            l1 = pointwise_ll(kind, dof, ev, args[4], args[5],
                              ipred).abs().sum().item()
            e = abs(out.item() - want.item())
            check(e <= 1e-5 * l1, f"fused_ll_fwd {kind} (noise "
                  f"{supplied is not None}): {out.item()} vs plain "
                  f"{want.item()}")
            err_fwd = max(err_fwd, e)
            got = kernels.fused_ll_bwd(*args, None, supplied, ev, ct, **cfg)
            ref = plain_fused_likelihood_grads(*args, None, ev, eps, ct,
                                               kind=kind, dof=dof)
            # Laplace's d ll / d ipred jumps at iobs = ipred: where the two
            # versions' ipred round to either side of iobs, both are right
            at_jump = torch.zeros_like(ipred, dtype=torch.bool)
            if kind == "laplace":
                at_jump = (args[4] - ipred).abs() <= 1e-5 * (
                    args[4].abs() + ipred.abs())
                jumps = max(jumps, int(at_jump.sum()))
            if kind.startswith("studentt"):
                studentt_check(torch, args, ev, eps,
                               None if supplied is not None else eps_k3, ct,
                               kind, dof, got[:4], ref[:4], "kernel phase")
            for name, g, r in zip(("dloc", "dscale", "da", "df"), got, ref):
                e = torch.where(at_jump, 0.0, (g - r).abs()).max().item()
                check(kind.startswith("studentt")
                      or e <= 1e-5 * r.abs().max().item(),
                      f"fused_ll_bwd {kind} {name}: max abs err {e}")
                err_bwd = max(err_bwd, e)
            if kind.endswith("_ev11"):
                _, terms = pointwise_grads(kind, dof, ev, args[4], args[5],
                                           ipred)
                for k, t in enumerate(terms):
                    e = abs(got[4][k].item() - ref[4][k].item())
                    check(e <= 1e-5 * ct.item() * t.abs().sum().item(),
                          f"fused_ll_bwd {kind} Ev11 grad {k}: "
                          f"{got[4][k].item()} vs {ref[4][k].item()}")
            else:
                check(got[4] is None, "fused_ll_bwd returned Ev11 grads")
        # in-kernel Philox against K3's normals fed in, and repeatability
        own = kernels.fused_ll_fwd(*args, None, None, ev, **cfg)
        check(torch.equal(own, kernels.fused_ll_fwd(*args, None, eps_k3, ev,
                                                    **cfg)),
              f"fused_ll_fwd {kind}: in-kernel eps differ from K3's")
        check(torch.equal(own, kernels.fused_ll_fwd(*args, None, None, ev,
                                                    **cfg)),
              f"fused_ll_fwd {kind} is not bitwise repeatable")
        g_own = kernels.fused_ll_bwd(*args, None, None, ev, ct, **cfg)
        g_k3 = kernels.fused_ll_bwd(*args, None, eps_k3, ev, ct, **cfg)
        check(all(a is b or torch.equal(a, b) for a, b in zip(g_own, g_k3)),
              f"fused_ll_bwd {kind}: in-kernel eps differ from K3's")

    # an offset that is not a multiple of 4: a ragged head and tail quad,
    # and no 16-byte loads; the same tolerance, its own eps K3's bitwise
    for kind, dof in (("normal", 0.0), ("studentt_ev11", 4.0)):
        cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset + 1,
                   t_const=studentt_log_norm(dof) if dof else 0.0)
        eps = plain_prng_normal(n, seed, offset + 1, dev)
        out = kernels.fused_ll_fwd(*args, None, None, ev, **cfg)
        want = plain_fused_likelihood_sum(*args, None, ev, eps, kind=kind,
                                          dof=dof)
        ipred = (args[2] * args[0] + args[2].abs() * args[1] * eps) \
            * args[3] * args[3]
        l1 = pointwise_ll(kind, dof, ev, args[4], args[5],
                          ipred).abs().sum().item()
        e = abs(out.item() - want.item())
        check(e <= 1e-5 * l1, f"fused_ll_fwd {kind} at offset {offset + 1}: "
              f"{out.item()} vs plain {want.item()}")
        err_fwd = max(err_fwd, e)
        k3 = kernels.philox_normal(n, seed, offset + 1, dev)
        check(torch.equal(out, kernels.fused_ll_fwd(*args, None, k3, ev,
                                                    **cfg)),
              f"fused_ll_fwd {kind} at offset {offset + 1}: in-kernel eps "
              "differ from K3's")

    times = {}
    for kind, dof in (("normal", 0.0), ("studentt_ev11", 4.0)):
        cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
                   t_const=studentt_log_norm(dof) if dof else 0.0)
        fwd_b = bound(K4_OPS_PER_OBS * n, 4.0 * 6 * n, peak_flops, peak_bw)
        bwd_b = bound(K4_OPS_PER_OBS * n, 4.0 * 10 * n, peak_flops, peak_bw)
        # the plain versions draw their normals too, as the kernels do
        times[kind] = {
            "fused_ll_fwd": dict(
                ms=time_ms(torch, lambda: kernels.fused_ll_fwd(
                    *args, None, None, ev, **cfg)),
                device_ms=device_ms(torch, lambda: kernels.fused_ll_fwd(
                    *args, None, None, ev, **cfg)),
                plain_ms=time_ms(torch, lambda: plain_fused_likelihood_sum(
                    *args, None, ev, plain_prng_normal(n, seed, offset, dev),
                    kind=kind, dof=dof), reps=20),
                bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None),
            "fused_ll_bwd": dict(
                ms=time_ms(torch, lambda: kernels.fused_ll_bwd(
                    *args, None, None, ev, ct, **cfg)),
                device_ms=device_ms(torch, lambda: kernels.fused_ll_bwd(
                    *args, None, None, ev, ct, **cfg)),
                plain_ms=time_ms(torch, lambda: plain_fused_likelihood_grads(
                    *args, None, ev, plain_prng_normal(n, seed, offset, dev),
                    ct, kind=kind, dof=dof), reps=20),
                bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None)}
    print("fused_ll at kind studentt_ev11 (slice (b)): "
          + json.dumps(times["studentt_ev11"]), flush=True)
    rows = {}
    for name, err in (("fused_ll_fwd", err_fwd), ("fused_ll_bwd", err_bwd)):
        rows[name] = dict(max_abs_err=err, **times["normal"][name],
                          kinds_checked=[k for k, _ in kinds],
                          philox_bitwise_k3=True)
    rows["fused_ll_bwd"]["laplace_obs_at_the_jump"] = jumps
    settled = studentt_settle(torch, dev)
    rows["fused_ll_bwd"]["studentt_settle"] = {
        "seeds": len(STUDENTT_SEEDS),
        **{f"max_{r}_ratio": max(v[r] for v in settled.values())
           for r in ("old", "new", "f64")}}
    return rows


def prng_gate(torch, kernels, dev):
    """Moments, 3/4/5-sigma tail mass and a chi-square over 100
    equal-probability bins for 2^22 normals from K3; every bound is ~5
    sigma of its statistic (binomial for the tails)."""
    n = 1 << 22
    x = kernels.philox_normal(n, 20241016, 0, dev).double()
    mean, var = x.mean().item(), x.var().item()
    check(abs(mean) < 5 / math.sqrt(n), f"prng mean {mean}")
    check(abs(var - 1) < 5 * math.sqrt(2 / n), f"prng variance {var}")
    tails = {}
    for k in (3, 4, 5):
        p = math.erfc(k / math.sqrt(2))
        count = int((x.abs() > k).sum())
        sd = math.sqrt(n * p * (1 - p))
        check(abs(count - n * p) <= 5 * sd + 1,
              f"prng {k}-sigma tail count {count}, expected {n * p:.1f}")
        tails[f"{k}sigma"] = [count, n * p]
    edges = torch.special.ndtri(
        torch.arange(1, 100, dtype=torch.float64, device=dev) / 100)
    counts = torch.bincount(torch.bucketize(x, edges), minlength=100)
    expect = n / 100
    chi2 = float(((counts.double() - expect) ** 2 / expect).sum())
    check(chi2 < 99 + 5 * math.sqrt(2 * 99), f"prng chi-square {chi2}")
    max_abs = x.abs().max().item()
    check(max_abs <= 5.8, f"prng max |x| {max_abs}")
    out = dict(n=n, mean=mean, var=var, chi2_99dof=chi2, max_abs=max_abs,
               **tails)
    print("prng gate: " + json.dumps(out))
    return out


def build_problem(seed, n_obs, n_refl, n_images, d_meta, laue=False):
    """The synthetic problem of bench.py (build_problem, bench.py:62-130),
    made with numpy from the seed: (arrays in Inputs.from_arrays order, the
    ASU collection, the true amplitudes). Laue (bench.py:81-128): harmonic
    chains of 1-4 reflections over a shuffled id table, each group a prefix
    of one chain on one image, its rows contiguous; the group-indexed
    intensities are the sums over each group, and `arrays` also holds
    wavelength and harmonic_id."""
    rng = np.random.default_rng(seed)
    refl_id = rng.integers(0, n_refl, n_obs)
    image_id = rng.integers(0, n_images, n_obs)
    if laue:
        perm_ids = rng.permutation(n_refl).astype(np.int64)
        clens = rng.choice([1, 2, 3, 4], size=n_refl,
                           p=[0.5, 0.25, 0.15, 0.10])
        clens = clens[np.cumsum(clens) <= n_refl]
        rem = n_refl - int(clens.sum())
        if rem:
            clens = np.append(clens, rem)
        n_chains = len(clens)
        chain_start = np.concatenate([[0], np.cumsum(clens)[:-1]])
        # groups until the row budget is filled, trimmed at a group
        # boundary and topped up with singletons to land on n_obs
        est = int(n_obs / 1.4 * 1.05) + 8
        gc = rng.integers(0, n_chains, est)
        gl = 1 + (rng.random(est) * clens[gc]).astype(np.int64)
        k = int(np.searchsorted(np.cumsum(gl), n_obs, side="right"))
        gc, gl = gc[:k], gl[:k]
        fill = n_obs - (int(gl.sum()) if k else 0)
        if fill:
            gc = np.concatenate([gc, rng.integers(0, n_chains, fill)])
            gl = np.concatenate([gl, np.ones(fill, np.int64)])
        n_groups = len(gl)
        hid = np.repeat(np.arange(n_groups), gl)
        row_start = np.repeat(np.concatenate([[0], np.cumsum(gl)[:-1]]), gl)
        member = np.arange(n_obs) - row_start
        refl_id = perm_ids[np.repeat(chain_start[gc], gl) + member]
        image_id = rng.integers(0, n_images, n_groups)[hid]
    metadata = rng.normal(size=(n_obs, d_meta)).astype(np.float32)
    f_true = np.abs(rng.normal(1.0, 0.5, n_refl)) + 0.05
    scale_true = np.exp(0.2 * metadata[:, 0])
    iobs = scale_true * f_true[refl_id] ** 2
    iobs = iobs + 0.1 * np.sqrt(np.abs(iobs)) * rng.normal(size=n_obs)
    sig = np.full(n_obs, 0.1, np.float32)
    arrays = (refl_id, image_id, np.zeros(n_obs), metadata, iobs, sig)
    if laue:
        grouped = np.zeros(n_groups, np.float32)
        np.add.at(grouped, hid, iobs.astype(np.float32))
        iobs = np.concatenate([grouped,
                               np.ones(n_obs - n_groups, np.float32)])
        arrays = arrays[:4] + (iobs, sig, np.ones(n_obs, np.float32), hid)
    centric = rng.random(n_refl) < 0.2
    asu = types.SimpleNamespace(centric=centric,
                                multiplicity=np.ones(n_refl, np.float32),
                                dHKL=np.ones(n_refl, np.float32))
    return arrays, asu, f_true


# the CLI phase's unmerged MTZ: 1M observations over P 21 21 21 at 1.5 A
# (~52k reflections in the ASU), 2,000 images, the 10 metadata keys below
CLI_OBS, CLI_IMAGES, CLI_STEPS = 1_000_000, 2_000, 300
CLI_CELL, CLI_SPACEGROUP, CLI_DMIN = (60.0, 70.0, 80.0, 90.0, 90.0, 90.0), \
    "P 21 21 21", 1.5
CLI_KEYS = "dHKL,image_id,Hobs,Kobs,Lobs,XDET,YDET,BG,SIGBG,FRACTIONCALC"
# the merged F's least correlation with the generator's true F after the
# CLI phase's 300 steps (0.8704 in the first card run, seed 0)
CLI_MIN_CC = 0.85


def synthetic_mtz(seed, n_obs, n_images, cell, spacegroup, dmin,
                  f_true=None, rel_sigma=0.05):
    """An unmerged data set made with numpy from the seed: ((columns, MTZ
    types) for write_mtz, the ASU's Miller indices, their true F). Every
    reflection of the ASU to dmin has F ~ sqrt(Exp(1)) (Wilson, acentric),
    or the given f_true (in the ASU's order);
    each observation picks a reflection, an image (BATCH 1..n_images) and a
    symmetry equivalent with either Friedel sign (its observed H, K, L;
    M/ISYM asks the writer to store the ASU index and the orientation);
    XDET, YDET, BG, SIGBG and FRACTIONCALC are detector-like columns.
    I = s F^2 + SIGI N(0, 1), SIGI = 0.05 + rel_sigma s F^2, with a scale s =
    exp(0.3 N(0, 1) per image + 0.2 (XDET - 0.5)) the model can learn from
    the metadata."""
    from careless_tpu_torch.xtal import SpaceGroup, UnitCell

    rng = np.random.default_rng(seed)
    sg = SpaceGroup.from_name(spacegroup)
    uc = UnitCell(*cell)
    hkl_asu = sg.generate_reciprocal_asu(uc, dmin)
    drawn = np.sqrt(rng.exponential(1.0, len(hkl_asu)))
    f_true = drawn if f_true is None else np.asarray(f_true)
    refl = rng.integers(0, len(hkl_asu), n_obs)
    image = rng.integers(0, n_images, n_obs)
    rots = np.stack([op.rot_array for op in sg.ops])
    op = rng.integers(0, len(rots), n_obs)
    sign = np.where(rng.random(n_obs) < 0.5, -1, 1)
    hkl = np.einsum("ni,nij->nj", hkl_asu[refl], rots[op]) * sign[:, None]
    xdet = rng.random(n_obs).astype(np.float32)
    ydet = rng.random(n_obs).astype(np.float32)
    scale = np.exp(0.3 * rng.normal(size=n_images)[image]
                   + 0.2 * (xdet - 0.5))
    i_true = scale * f_true[refl] ** 2
    sig = 0.05 + rel_sigma * i_true
    cols = {"H": hkl[:, 0].astype(np.int32), "K": hkl[:, 1].astype(np.int32),
            "L": hkl[:, 2].astype(np.int32),
            "M/ISYM": np.zeros(n_obs, np.int32),
            "BATCH": (image + 1).astype(np.int32),
            "I": (i_true + sig * rng.normal(size=n_obs)).astype(np.float32),
            "SIGI": sig.astype(np.float32), "XDET": 2048 * xdet,
            "YDET": 2048 * ydet,
            "BG": rng.gamma(2.0, 5.0, n_obs).astype(np.float32),
            "SIGBG": rng.uniform(1.0, 3.0, n_obs).astype(np.float32),
            "FRACTIONCALC": rng.uniform(0.5, 1.0, n_obs).astype(np.float32)}
    types_ = {"H": "H", "K": "H", "L": "H", "M/ISYM": "Y", "BATCH": "B",
              "I": "J", "SIGI": "Q", "XDET": "R", "YDET": "R", "BG": "R",
              "SIGBG": "R", "FRACTIONCALC": "R"}
    return (cols, types_), hkl_asu, f_true


# the poly CLI phase's Laue MTZ: PYP in P 63 to 1.6 A (13,872 reflections
# in the ASU), a pink-beam band of 0.95-1.25 A, 3,000,000 spots on 4,000
# images, the 10 metadata keys below (d = w = 10 at 20 layers)
POLY_SPOTS, POLY_IMAGES, POLY_STEPS, POLY_WARM_STEPS = \
    3_000_000, 4_000, 300, 20
POLY_CELL, POLY_SPACEGROUP, POLY_DMIN, POLY_BAND = \
    (66.9, 66.9, 40.8, 90.0, 90.0, 120.0), "P 63", 1.6, (0.95, 1.25)
POLY_KEYS = "dHKL,image_id,Wavelength,XDET,YDET,Hobs,Kobs,Lobs,BG,SIGBG"
# the merged F's least correlation with the generator's true F after the
# poly CLI phase's 300 steps (0.7920 in the first card run, seed 0)
POLY_MIN_CC = 0.75


def primitive_rays(cell, dmin):
    """(n, 3) Miller indices of every central ray to dmin in P 1: the
    reflections with d >= dmin whose indices share no factor."""
    from careless_tpu_torch.xtal import UnitCell

    uc = UnitCell(*cell)
    r = [int(math.ceil(x / dmin)) for x in cell[:3]]
    grid = np.stack(np.meshgrid(*[np.arange(-m, m + 1) for m in r],
                                indexing="ij"), -1).reshape(-1, 3)
    grid = grid[np.abs(grid).sum(1) > 0]
    keep = (uc.compute_d(grid) >= dmin) \
        & (np.gcd.reduce(np.abs(grid), axis=1) == 1)
    return grid[keep]


def synthetic_laue_mtz(seed, n_spots, n_images, cell, spacegroup, dmin,
                       band):
    """A Laue data set made with numpy from the seed: ((columns, MTZ types)
    for write_mtz, the ASU's Miller indices, their true F, the number of
    harmonics each spot holds). Every reflection of the ASU to dmin has F ~
    sqrt(Exp(1)). Each image holds n_spots / n_images spots on distinct
    central rays H_0 (primitive_rays), as a detector does; a spot reports
    one harmonic n H_0 of its ray (n uniform up to the ray's last harmonic
    within dmin) at a wavelength uniform in the band. Its intensity is
    s sum_n F(n H_0)^2 over the harmonics the Laue formatter keeps (within
    the file's dmin and wavelength range, not systematically absent; the
    formatter's own float32 arithmetic), plus noise SIGI N(0, 1), SIGI =
    0.05 + 0.05 s sum_n F^2, s = exp(0.3 N(0, 1) per image + 0.2 (XDET -
    0.5)). Spots whose reported harmonic is absent are not made."""
    from careless_tpu_torch.io.asu import pack_hkl
    from careless_tpu_torch.xtal import SpaceGroup, UnitCell

    rng = np.random.default_rng(seed)
    sg = SpaceGroup.from_name(spacegroup)
    uc = UnitCell(*cell)
    hkl_asu = sg.generate_reciprocal_asu(uc, dmin)
    f_true = np.sqrt(rng.exponential(1.0, len(hkl_asu)))
    rays = primitive_rays(cell, dmin)
    ray_nmax = np.floor(uc.compute_d(rays) / dmin).astype(np.int64)
    # distinct (image, ray) pairs, a few more drawn than kept
    draw = int(n_spots * 1.02) + 64
    pair = np.unique(rng.integers(0, n_images, draw) * len(rays)
                     + rng.integers(0, len(rays), draw))
    image, ray = pair // len(rays), pair % len(rays)
    n_rep = 1 + (rng.random(len(ray)) * ray_nmax[ray]).astype(np.int64)
    hkl = rays[ray] * n_rep[:, None]
    ok = ~sg.is_absent(hkl)
    pick = np.sort(rng.choice(np.flatnonzero(ok), n_spots, replace=False))
    image, ray, n_rep, hkl = image[pick], ray[pick], n_rep[pick], hkl[pick]
    lam = rng.uniform(*band, n_spots).astype(np.float32)

    # the harmonics the formatter keeps, in its arithmetic
    d32 = uc.compute_d(hkl).astype(np.float32)
    d_min = float(d32.min())
    lam_lo, lam_hi = float(lam.min()), float(lam.max())
    n_max = np.floor_divide(d32.astype(np.float64) * n_rep, d_min
                            ).astype(np.int64)
    spot, n = np.nonzero(np.arange(1, n_max.max() + 1)[None, :]
                         <= n_max[:, None])
    n = n + 1
    lam_n = (lam.astype(np.float64)[spot] * n_rep[spot] / n
             ).astype(np.float32)
    h_n = rays[ray[spot]] * n[:, None]
    kept = (lam_n >= lam_lo) & (lam_n <= lam_hi) & ~sg.is_absent(h_n)
    asu, _ = sg.map_to_asu(h_n[kept], anomalous=False)
    keys = pack_hkl(hkl_asu)
    at = np.searchsorted(keys, pack_hkl(asu))
    f2_sum = np.bincount(spot[kept], weights=f_true[at] ** 2,
                         minlength=n_spots)
    harmonics = np.bincount(spot[kept], minlength=n_spots)

    xdet = rng.random(n_spots).astype(np.float32)
    ydet = rng.random(n_spots).astype(np.float32)
    scale = np.exp(0.3 * rng.normal(size=n_images)[image]
                   + 0.2 * (xdet - 0.5))
    i_true = scale * f2_sum
    sig = 0.05 + 0.05 * i_true
    cols = {"H": hkl[:, 0].astype(np.int32), "K": hkl[:, 1].astype(np.int32),
            "L": hkl[:, 2].astype(np.int32),
            "BATCH": (image + 1).astype(np.int32),
            "I": (i_true + sig * rng.normal(size=n_spots)).astype(np.float32),
            "SIGI": sig.astype(np.float32), "Wavelength": lam,
            "XDET": 2048 * xdet, "YDET": 2048 * ydet,
            "BG": rng.gamma(2.0, 5.0, n_spots).astype(np.float32),
            "SIGBG": rng.uniform(1.0, 3.0, n_spots).astype(np.float32)}
    types_ = {"H": "H", "K": "H", "L": "H", "BATCH": "B", "I": "J",
              "SIGI": "Q", "Wavelength": "R", "XDET": "R", "YDET": "R",
              "BG": "R", "SIGBG": "R"}
    return (cols, types_), hkl_asu, f_true, harmonics


# the stream CLI phase: a serial-crystallography merge of lysozyme-like
# crystals (P 43 21 2) to 2.0 A, 2,500 crystals of 200 reflections each,
# 300 steps (at 100 the merged F had not left the prior: CC 0.095 on the
# card; 0.63 after 300 at 100k reflections on the CPU, where 100 gave 0.11)
STREAM_REFL, STREAM_CRYSTALS, STREAM_STEPS = 500_000, 2_500, 300
# the merged F's least correlation with the true F after those 300 steps
STREAM_MIN_CC = 0.5
STREAM_CELL, STREAM_SPACEGROUP, STREAM_DMIN = \
    (79.1, 79.1, 38.4, 90.0, 90.0, 90.0), "P 43 21 2", 2.0
STREAM_KEYS = "BATCH,s1x,s1y,s1z,ewald_offset"
# the native parser held against the Python reader on a stream of this many
# reflections and crystals (the Python reader takes about a second on it)
STREAM_CHECK_REFL, STREAM_CHECK_CRYSTALS = 50_000, 250
# the geometry columns' largest difference, in ulps of f32, between the two
# parsers: -march=native may contract the C++'s products into FMAs
STREAM_GEOMETRY_ULPS = 1


def synthetic_stream(seed, path, n_refl, n_crystals, cell, spacegroup, dmin):
    """Write a CrystFEL stream made with numpy from the seed: each crystal
    (chunk) at a random orientation and a photon energy of 9,500 eV +-
    0.2 %, its n_refl / n_crystals reflections those nearest the Ewald
    sphere among a strided eighth of the P 1 reflections to dmin; I = s
    F^2 exp(-(e / 0.004)^2 / 2) + SIGI N(0, 1) with e the Ewald offset,
    SIGI = 0.05 + 0.05 of the noiseless I, s = exp(0.3 N(0, 1)) per
    crystal. Returns (the ASU's Miller indices, their true F)."""
    from careless_tpu_torch.io.asu import pack_hkl
    from careless_tpu_torch.xtal import SpaceGroup, UnitCell

    rng = np.random.default_rng(seed)
    sg = SpaceGroup.from_name(spacegroup)
    uc = UnitCell(*cell)
    hkl_asu = sg.generate_reciprocal_asu(uc, dmin)
    f_true = np.sqrt(rng.exponential(1.0, len(hkl_asu)))
    keys = pack_hkl(hkl_asu)
    r = [int(math.ceil(x / dmin)) for x in cell[:3]]
    cand = np.stack(np.meshgrid(*[np.arange(-m, m + 1) for m in r],
                                indexing="ij"), -1).reshape(-1, 3)
    cand = cand[(np.abs(cand).sum(1) > 0) & (uc.compute_d(cand) >= dmin)
                & ~sg.is_absent(cand)]
    asu, _ = sg.map_to_asu(cand, anomalous=False)
    f_cand = f_true[np.searchsorted(keys, pack_hkl(asu))]
    per = n_refl // n_crystals
    b_star = np.linalg.inv(uc.orthogonalization_matrix())   # rows a*, b*, c*
    lines = ["CrystFEL stream format 2.3", "Generated by chip_smoke.py",
             "----- Begin unit cell -----",
             "CrystFEL unit cell file version 1.0", "",
             "lattice_type = tetragonal", "centering = P", "unique_axis = c",
             *(f"{k} = {v:.2f} {u}" for k, v, u in zip(
                 ("a", "b", "c", "al", "be", "ga"), cell,
                 ("A", "A", "A", "deg", "deg", "deg"))),
             "----- End unit cell -----"]
    for c in range(n_crystals):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                         2 * (x * z + y * w)],
                        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                         2 * (y * z - x * w)],
                        [2 * (x * z - y * w), 2 * (y * z + x * w),
                         1 - 2 * (x * x + y * y)]])
        amat = b_star @ rot.T
        energy = 9500.0 * (1 + 0.002 * rng.normal())
        k0 = energy / 12398.419843320026
        sub = slice(int(rng.integers(0, 8)), None, 8)
        svec = cand[sub] @ amat
        e = np.linalg.norm(svec + [0.0, 0.0, k0], axis=1) - k0
        near = np.argpartition(np.abs(e), per)[:per]
        hkl = cand[sub][near]
        i_true = (np.exp(0.3 * rng.normal()) * f_cand[sub][near] ** 2
                  * np.exp(-0.5 * (e[near] / 0.004) ** 2))
        sig = 0.05 + 0.05 * i_true
        inten = i_true + sig * rng.normal(size=per)
        fs, ss = rng.uniform(0, 2000, (2, per))
        lines += ["----- Begin chunk -----", "Image filename: sim.h5",
                  f"Event: //{c}", f"photon_energy_eV = {energy:.6f}",
                  "--- Begin crystal",
                  *(f"{n} = {v[0]:+.7f} {v[1]:+.7f} {v[2]:+.7f} nm^-1"
                    for n, v in zip(("astar", "bstar", "cstar"), amat * 10)),
                  "Reflections measured after indexing",
                  "   h    k    l          I   sigma(I)       peak "
                  "background  fs/px  ss/px panel"]
        lines += [f"{h:4d} {k:4d} {l:4d} {i:10.2f} {s:10.2f} {p:10.2f} "
                  f"{b:10.2f} {f:6.1f} {g:6.1f} p0"
                  for (h, k, l), i, s, p, b, f, g in zip(
                      hkl.tolist(), inten.tolist(), sig.tolist(),
                      (2 * inten).tolist(), [10.0] * per, fs.tolist(),
                      ss.tolist())]
        lines += ["End of reflections", "--- End crystal",
                  "----- End chunk -----"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return hkl_asu, f_true


# the modules a DIALS installation provides that stills2mtz imports
DIALS_MODULES = ("dials", "dials.array_family", "dials.array_family.flex",
                 "dxtbx", "dxtbx.model", "dxtbx.model.experiment_list")


@contextlib.contextmanager
def dials_stand_in():
    """A stand-in for DIALS, not DIALS: within it, sys.modules holds
    DIALS_MODULES with exactly the six calls both stills2mtz scripts make
    (flex.reflection_table.from_file, a column's as_numpy_array and
    as_vec3_double, `key in table`, and ExperimentListFactory.from_json_file
    (path)[0].crystal's get_unit_cell().parameters() and get_space_group()
    .type().universal_hermann_mauguin_symbol()). Its "refl" file is an .npz
    of the table's columns by DIALS's names, its "expt" file a JSON object
    {"cell": [six parameters], "space_group": symbol}, as synthetic_stills
    writes them; DIALS's own .refl (msgpack) and .expt files it cannot read.
    On exit the modules that were there before (none, without DIALS) are
    put back."""
    class Column:
        def __init__(self, values):
            self._values = values

        def as_numpy_array(self):
            return self._values.copy()

        def as_vec3_double(self):
            return Column(self._values.astype(np.float64))

    class ReflectionTable:
        def __init__(self, cols):
            self._cols = cols

        @classmethod
        def from_file(cls, path):
            with np.load(path) as z:
                return cls({k: z[k] for k in z.files})

        def __getitem__(self, key):
            return Column(self._cols[key])

        def __contains__(self, key):
            return key in self._cols

    class ExperimentListFactory:
        @staticmethod
        def from_json_file(path):
            with open(path) as f:
                expt = json.load(f)
            ns = types.SimpleNamespace
            symbol = ns(universal_hermann_mauguin_symbol=lambda: expt[
                "space_group"])
            crystal = ns(get_unit_cell=lambda: ns(
                parameters=lambda: tuple(expt["cell"])),
                get_space_group=lambda: ns(type=lambda: symbol))
            return [ns(crystal=crystal)]

    made = {name: types.ModuleType(name) for name in DIALS_MODULES}
    made["dials.array_family.flex"].reflection_table = ReflectionTable
    made["dxtbx.model.experiment_list"].ExperimentListFactory = \
        ExperimentListFactory
    for name, mod in made.items():
        if "." in name:
            parent, child = name.rsplit(".", 1)
            setattr(made[parent], child, mod)
    before = {name: sys.modules.get(name) for name in DIALS_MODULES}
    sys.modules.update(made)
    try:
        yield
    finally:
        for name, mod in before.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


# the optional columns of a DIALS stills table that stills2mtz reads
STILLS_COLUMNS = ("cartesian_fixed_obs", "cartesian_fixed", "Rh")
# the stills phase: a time-resolved SFX data set like MbCO myoglobin
# (P 1 21 1 to 1.8 A, ~12k reflections in the ASU), 1,000,000 reflections
# on 5,000 stills, every optional column, merged 300 steps with the eight
# metadata keys below (d = w = 8 at 20 layers; BATCH, the one B column, is
# the image key)
STILLS_REFL, STILLS_STILLS, STILLS_STEPS = 1_000_000, 5_000, 300
STILLS_CELL, STILLS_SPACEGROUP, STILLS_DMIN = \
    (64.5, 30.6, 34.9, 90.0, 105.5, 90.0), "P 1 21 1", 1.8
STILLS_KEYS = ("dHKL,BATCH,ewald_offset,xobs,yobs,cartesian_delta_x,"
               "cartesian_delta_y,cartesian_delta_z")
# the merged F's least correlation with the true F after those 300 steps
# (the same phase on the CPU, seed 0: 0.8562 at 100k reflections on 500
# stills, 0.8808 at 300k on 1,500)
STILLS_MIN_CC = 0.85


def synthetic_stills(seed, refl, expt, n_refl, n_stills, cell, spacegroup,
                     dmin, columns=STILLS_COLUMNS, negative=8):
    """Write a DIALS-like stills table and experiment list, made with numpy
    from the seed, in dials_stand_in's formats (`refl`: .npz, `expt`:
    JSON): n_refl / n_stills reflections a still (DIALS's int32 `id`,
    0 .. n_stills - 1), each a reflection of the ASU to dmin sent to a
    random symmetry equivalent with either Friedel sign (int32
    miller_index); intensity.sum.value I = s F^2 + SIGI N(0, 1) with
    F ~ sqrt(Exp(1)), s = exp(0.3 N(0, 1)) per still, SIGI = 0.05 + 0.05 s
    F^2, and intensity.sum.variance SIGI^2, negated on `negative` seeded
    rows; xyzcal.px and xyzobs.px.value pixel positions (x, y on a
    2,000-pixel detector, z 0; obs = cal + N(0, 0.5) in x and y); and,
    those of STILLS_COLUMNS that `columns` names, Rh (Ewald offsets,
    N(0, 0.002) per A), cartesian_fixed (random unit vectors) and
    cartesian_fixed_obs (the same, moved by N(0, 0.001) and renormalised).
    Returns (the ASU's Miller indices, their true F)."""
    from careless_tpu_torch.xtal import SpaceGroup, UnitCell

    rng = np.random.default_rng(seed)
    sg = SpaceGroup.from_name(spacegroup)
    hkl_asu = sg.generate_reciprocal_asu(UnitCell(*cell), dmin)
    f_true = np.sqrt(rng.exponential(1.0, len(hkl_asu)))
    still = np.repeat(np.arange(n_stills, dtype=np.int32),
                      -(-n_refl // n_stills))[:n_refl]
    pick = rng.integers(0, len(hkl_asu), n_refl)
    rots = np.stack([op.rot_array for op in sg.ops])
    op = rng.integers(0, len(rots), n_refl)
    sign = np.where(rng.random(n_refl) < 0.5, -1, 1)
    hkl = np.einsum("ni,nij->nj", hkl_asu[pick], rots[op]) * sign[:, None]
    i_true = np.exp(0.3 * rng.normal(size=n_stills))[still] \
        * f_true[pick] ** 2
    sig = 0.05 + 0.05 * i_true
    variance = sig ** 2
    variance[rng.choice(n_refl, negative, replace=False)] *= -1
    cal = np.zeros((n_refl, 3))
    cal[:, :2] = rng.uniform(0, 2000, (n_refl, 2))
    obs = cal.copy()
    obs[:, :2] += rng.normal(0, 0.5, (n_refl, 2))
    table = {"miller_index": hkl.astype(np.int32), "id": still,
             "intensity.sum.value": i_true + sig * rng.normal(size=n_refl),
             "intensity.sum.variance": variance, "xyzcal.px": cal,
             "xyzobs.px.value": obs}
    fixed = rng.normal(size=(n_refl, 3))
    fixed /= np.linalg.norm(fixed, axis=1, keepdims=True)
    moved = fixed + rng.normal(0, 0.001, (n_refl, 3))
    moved /= np.linalg.norm(moved, axis=1, keepdims=True)
    optional = {"cartesian_fixed_obs": moved, "cartesian_fixed": fixed,
                "Rh": rng.normal(0, 0.002, n_refl)}
    table.update({k: optional[k] for k in columns})
    with open(refl, "wb") as f:
        np.savez(f, **table)
    with open(expt, "w") as f:
        json.dump({"cell": list(cell), "space_group": spacegroup}, f)
    return hkl_asu, f_true


def model_on(device, seed, n_obs, n_refl, n_images, d_meta, n_layers,
             flags=None, laue=False, times=None, two_files=False,
             plans=True):
    """The model of the CLI's defaults with `flags` on top, built by
    DataManager.build_model on `device` (None: the card), on rows sorted by
    refl_id (mono) or in the harmonic-chain layout (Laue), with plans
    (without them when not `plans`: the layout a shard is cut from).
    `times`, when given, receives the host seconds of each set-up step.
    two_files: the problem of two_file_problem (n_refl unused)."""
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.models.base import Inputs

    times = {} if times is None else times
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        times[name] = t1 - t0
        t0 = t1

    if two_files:
        arrays, asu, f_true = two_file_problem(seed, n_obs, n_images, d_meta)
    else:
        arrays, asu, f_true = build_problem(seed, n_obs, n_refl, n_images,
                                            d_meta, laue=laue)
    lap("problem_s")
    parser = types.SimpleNamespace(**{**MONO_DEFAULTS,
                                      "mlp_layers": n_layers, **(flags or {})})
    dm = DataManager(Inputs.from_arrays(*arrays, device=device), asu, parser,
                     device=device)
    model, params, trainer = dm.build_model()
    lap("model_s")
    inputs = (dm.inputs.sorted_by_harmonic(dm.n_refl) if laue
              else dm.inputs.sorted_by_refl())
    lap("layout_s")
    if plans:
        inputs = inputs.with_plans(dm.n_refl, dm.n_images)
    lap("plans_s")
    return model, params, trainer, inputs, f_true


def two_file_problem(seed, n_obs, n_images, d_meta, cell=CLI_CELL,
                     spacegroup=CLI_SPACEGROUP, dmin=3.0):
    """build_problem's mono problem over two files of one ASU each (a real
    ReciprocalASUCollection, as --separate-files gives: the double-Wilson
    prior's parent table needs its Miller indices), every observation's
    file_id its reflection's file."""
    from careless_tpu_torch.io.asu import (ReciprocalASU,
                                           ReciprocalASUCollection)
    from careless_tpu_torch.xtal import SpaceGroup, UnitCell

    asu = ReciprocalASU(UnitCell(*cell), SpaceGroup.from_name(spacegroup),
                        dmin, False)
    rac = ReciprocalASUCollection([asu, asu])
    arrays, _, f_true = build_problem(seed, n_obs, rac.n_refl, n_images,
                                      d_meta)
    file_id = rac.asu_ids[arrays[0]]
    return arrays[:2] + (file_id,) + arrays[3:], rac, f_true


# the double-Wilson flags of a parent and its child at r = 0.9, r trained
DOUBLE_WILSON = dict(parents="None,0", dwr="0.,0.9",
                     optimize_double_wilson_r=True)


def grad_rel_err(g_a, g_b):
    """The largest per-tensor error relative to the tensor's largest entry."""
    return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(g_a, g_b))


def check_phase(torch, dev, seed, flags=None, label="default",
                two_files=False, library=False):
    """Loss and every parameter gradient of the port at a small size on
    the card (kernels) against the same computation on the CPU (plain
    versions), at the same parameters, reflection noise and scale noise
    (mc = 1), for the CLI defaults with `flags` on top (on
    two_file_problem's two files when two_files: the double-Wilson
    prior's; with library, the library phase's parts, library_parts,
    whose RiceWoolfson posterior takes three normals a reflection)."""
    from careless_tpu_torch.models.merging.variational import (
        flatten_params, map_params)
    from careless_tpu_torch.utils.params import (params_from_jax,
                                                 params_to_numpy)

    sizes = (20_000, 2_000, 50, D_META, N_LAYERS)
    rng = np.random.default_rng(seed + 1)
    eps = rng.standard_normal(sizes[0]).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        model, params, trainer, inputs, f_true = model_on(
            device, seed, *sizes, flags=flags, two_files=two_files)
        if library:
            model, params, _ = library_parts(model, params, trainer, f_true,
                                             seed)
        if not results:
            n_refl = inputs.plans.refl.table_size
            u_f = (rng.standard_normal((3, n_refl)) if library
                   else rng.random(n_refl)).astype(np.float32)
            # perturb the identity-initialised MLP so every layer matters
            start = map_params(lambda a: a + 0.05 * rng.standard_normal(
                a.shape).astype(np.float32), params_to_numpy(params))
            start["posterior"] = params_to_numpy(params["posterior"])
        p = params_from_jax(start, device)
        leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
        loss, _ = model.elbo(p, inputs,
                             u_f=torch.as_tensor(u_f, device=device),
                             eps=torch.as_tensor(eps, device=device))
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss.item(), [g.cpu() for g in grads]))
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    rel = abs(l_dev - l_cpu) / abs(l_cpu)
    # f32 sums over 20k observations taken in another order
    check(rel < 1e-4, f"check ({label}): loss on the card {l_dev} vs CPU "
          f"{l_cpu}")
    g_err = grad_rel_err(g_dev, g_cpu)
    check(g_err < 1e-3, f"check ({label}): gradients on the card vs CPU: "
          f"rel err {g_err}")
    print(f"check ({label}, {type(model.scaler).__name__}, "
          f"{type(model.prior).__name__}, "
          f"{type(model.posterior).__name__}, "
          f"{type(model.likelihood).__name__}): loss "
          f"{l_dev:.6f} vs CPU {l_cpu:.6f} (rel {rel:.2e}); "
          f"max per-tensor grad rel err {g_err:.2e} over {len(g_dev)} "
          "tensors", flush=True)


def check_mc2_phase(torch, dev, seed):
    """At 20k observations and mc = 2 with K4 forced on, for the flag sets
    of slices (a) and (b): loss and every gradient (the likelihood's raw
    Ev11 leaves included) on the card against the CPU at the same
    parameters, uniforms and Philox key (the CPU draws the same words in its
    plain version); then on the card the fused ELBO against the unfused one
    (eps from one K3 launch) at the same key and uniforms. Tolerances: card
    vs CPU as at mc = 1; fused vs unfused loss rel 1e-5 and gradients 1e-4
    of each tensor's largest entry (the same normals, the chain rounded in
    another order, sums over 40k terms in another order)."""
    import dataclasses

    from careless_tpu_torch.models.merging.variational import (
        flatten_params, map_params)
    from careless_tpu_torch.utils.params import (params_from_jax,
                                                 params_to_numpy)

    sizes = (20_000, 2_000, 50, D_META, N_LAYERS)
    key = 12345 | (7 << 32)
    for label, flags in (("a", SLICE_A), ("b", SLICE_B)):
        flags = {**flags, "fused_kernel": "on"}
        rng = np.random.default_rng(seed + 2)
        u_f = rng.random((2, sizes[1])).astype(np.float32)
        results, start = [], None
        for device, paths in (("cpu", (True,)), (dev, (True, False))):
            model, params, _, inputs, _ = model_on(device, seed, *sizes,
                                                   flags=flags)
            check(model.fused_kernel and model.mc_samples == 2,
                  "mc = 2 with --fused-kernel on did not select K4")
            if start is None:
                start = map_params(lambda a: a + 0.05 * rng.standard_normal(
                    a.shape).astype(np.float32), params_to_numpy(params))
                start["posterior"] = params_to_numpy(params["posterior"])
            for fused in paths:
                m = dataclasses.replace(model, fused_kernel=fused)
                p = params_from_jax(start, device)
                named = flatten_params(p)
                leaves = [t.requires_grad_(True) for _, t in named]
                loss, _ = m.elbo(p, inputs, seed=key,
                                 u_f=torch.as_tensor(u_f, device=device))
                grads = torch.autograd.grad(loss, leaves)
                results.append((loss.item(), [g.cpu() for g in grads]))
        (l_cpu, g_cpu), (l_dev, g_dev), (l_unf, g_unf) = results
        rel = abs(l_dev - l_cpu) / abs(l_cpu)
        check(rel < 1e-4, f"mc2 ({label}): loss on the card {l_dev} vs CPU "
              f"{l_cpu}")
        g_err = grad_rel_err(g_dev, g_cpu)
        check(g_err < 1e-3, f"mc2 ({label}): gradients on the card vs CPU: "
              f"rel err {g_err}")
        rel_unf = abs(l_dev - l_unf) / abs(l_unf)
        check(rel_unf < 1e-5, f"mc2 ({label}): fused loss {l_dev} vs "
              f"unfused {l_unf} on the card")
        g_unf_err = grad_rel_err(g_dev, g_unf)
        check(g_unf_err < 1e-4, f"mc2 ({label}): fused vs unfused gradients "
              f"on the card: rel err {g_unf_err}")
        paths = [k for k, _ in named]
        print(f"check mc2 ({label}): loss {l_dev:.6f} vs CPU {l_cpu:.6f} "
              f"(rel {rel:.2e}), grad rel err {g_err:.2e} over "
              f"{len(paths)} tensors ({', '.join(paths[:3])}, ...); fused "
              f"vs unfused on the card: loss {l_dev:.6f} vs {l_unf:.6f} "
              f"(rel {rel_unf:.2e}), grad rel err {g_unf_err:.2e}",
              flush=True)


def slice_phase(torch, dev, seed, steps, chunk, label="default",
                flags=None):
    """Build and train one mono slice at full width; returns (launches over
    the measured run, model, initial and trained params, the slice's
    summary with its profile)."""
    t0 = time.perf_counter()
    times = {}
    built = model_on(None, seed, N_OBS, N_REFL, N_IMAGES, D_META, N_LAYERS,
                     flags=flags, times=times)
    torch.cuda.synchronize()
    return train_slice(torch, dev, seed, *built, steps, chunk, label, flags,
                       time.perf_counter() - t0, times)


def train_slice(torch, dev, seed, model, params, trainer, inputs, f_true,
                steps, chunk, label, flags, setup_s, setup_times):
    """Train a built slice: a 5-step warm-up, then `steps` steps in chunks
    of `chunk` with every kernel count set to 0 just before them; returns
    (launches over that run, model, initial and trained params, the
    printed summary with profile_steps' numbers added)."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.device import seeded_generator

    # warm-up (first launches, cuBLAS handles), then the measured run
    trainer.train(params, seeded_generator(seed + 100, dev), inputs, 5,
                  chunk_size=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trained, history = trainer.train(params, seeded_generator(seed, dev),
                                     inputs, steps, chunk_size=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    loss = np.asarray(history["loss"])
    check(len(loss) == steps, f"training stopped at {len(loss)} steps")
    check(bool(np.all(np.isfinite(loss))), "non-finite loss")
    first, last = loss[:chunk].mean(), loss[-chunk:].mean()
    check(last < first, f"loss did not fall: {first} -> {last}")
    q = model.posterior.distribution(trained["posterior"])
    corr = float(np.corrcoef(q.mean().detach().cpu().numpy(), f_true)[0, 1])
    out = dict(slice=label, flags=flags or {}, n_obs=inputs.n_obs,
               mc_samples=model.mc_samples, fused_kernel=model.fused_kernel,
               scaler=type(model.scaler).__name__,
               likelihood=type(model.likelihood).__module__.rsplit(".")[-1]
               + "." + type(model.likelihood).__name__,
               steps=steps, chunk=chunk, steps_per_s=steps / wall,
               ms_per_step=1e3 * wall / steps, setup_s=setup_s,
               setup_breakdown_s=setup_times,
               loss_first_chunk=float(first), loss_last_chunk=float(last),
               posterior_mean_corr_f_true=corr,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step={k: v / steps for k, v in launches.items()})
    print("slice: " + json.dumps(out), flush=True)
    out.update(profile_steps(torch, trainer, trained, inputs, seed,
                             out["ms_per_step"]))
    return launches, model, params, trained, out


def k5_case(torch, dev, gen, x, ids2d, bases, window, block_rows, perm,
            peak_flops, peak_bw, label, calls=10_000):
    """K5 at one case: held bit for bit against its plain version, x[perm],
    index_select and K2 on the same flat ids (K5's windows are the plan's,
    padded with the last id, so all compute the same (R * 128,) values),
    then timed beside them: CUDA events, host time per call over `calls`
    back-to-back calls, device time warm and after an L2 flush."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.table_gather import (plain_windowed_gather,
                                                     windowed_gather_stream)

    n = x.shape[0]
    args = (x, ids2d, bases, window, block_rows)
    got = windowed_gather_stream(*args)
    check(torch.equal(got, plain_windowed_gather(*args)),
          f"gather_stream ({label}) differs from plain")
    check(torch.equal(got[:n], x[perm.long()]),
          f"gather_stream ({label}) differs from x[perm]")
    flat = ids2d.reshape(-1)
    check(torch.equal(got, kernels.gather(x, flat))
          and torch.equal(got, torch.index_select(x, 0, flat)),
          f"gather_stream ({label}) differs from K2 or index_select on the "
          "flat ids")
    del got
    n_ids = flat.numel()
    b_ms, b_by = bound(0.0, 4.0 * (2 * n_ids + n), peak_flops, peak_bw)
    timed = gather_timings(
        torch, {"": lambda: kernels.gather_stream(*args),
                "library_": lambda: torch.index_select(x, 0, flat),
                "k2_": lambda: kernels.gather(x, flat)},
        l2_flush(torch, dev), calls)
    row = dict(
        max_abs_err=0.0, tolerance=0.0,
        ms=time_ms(torch, lambda: kernels.gather_stream(*args)),
        plain_ms=time_ms(torch, lambda: plain_windowed_gather(*args),
                         reps=10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: torch.index_select(x, 0, flat)),
        k2_ms=time_ms(torch, lambda: kernels.gather(x, flat)),
        **timed, host_calls=calls,
        n=n, window=window, block_rows=block_rows,
        n_tiles=bases.shape[0],
        staged_bytes=bases.shape[0] * window * 128 * 4,
        bound_bytes=4 * (2 * n_ids + n))
    print(f"gather_stream ({label}): " + json.dumps(row), flush=True)
    return row


def swap_windows(torch, dev):
    """The JAX package's hardware test of the stream kernel (tests/ops/
    test_chain_layout.py:249-269): a 300k quasi-identity permutation with
    swaps at offsets 3, 17 and 111, windowed as that test windows it;
    (perm, ids2d, bases, window) on dev."""
    from careless_tpu_torch.ops.plan_gather import _plan_windows

    n = 300_000
    perm = np.arange(n, dtype=np.int64)
    for off in (3, 17, 111):
        i = np.arange(0, n - off, off * 13)
        perm[i], perm[i + off] = perm[i + off].copy(), perm[i].copy()
    ids2d, bases, window = _plan_windows(perm.astype(np.int32), n,
                                         max_chunks=160, max_rows=1 << 20)
    check(window > 0, "the swap permutation does not window")
    return (torch.as_tensor(perm, device=dev),
            torch.as_tensor(ids2d, device=dev),
            torch.as_tensor(bases, device=dev), window)


def swap_case(torch, dev, gen, peak_flops, peak_bw):
    """K5 at the JAX package's 300k swap permutation (swap_windows)."""
    perm, ids2d, bases, window = swap_windows(torch, dev)
    x = torch.randn(perm.shape[0], generator=gen, device=dev)
    return k5_case(torch, dev, gen, x, ids2d, bases, window, 64, perm,
                   peak_flops, peak_bw, "swap permutation, 300k")


def elbo_and_grads(torch, model, start, inputs, device, **kw):
    """(loss, gradients on the CPU) of model.elbo at the numpy params."""
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.utils.params import params_from_jax

    p = params_from_jax(start, device)
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    loss, _ = model.elbo(p, inputs, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), [g.cpu() for g in grads]


def check_laue_phase(torch, dev, seed):
    """The Laue ELBO at 50k observations, 5k reflections and 50 images with
    the VMEM cap of ops/plan_gather.py lowered to 64 rows (50k
    observations are 391), so that the chain plan's backward permute and
    the harmonic plan stream, as they do at 10M. The refl table is within
    the JAX package's one-hot histogram cap (32,768 entries), so at mc = 1
    the JAX package would take the histogram there and run no stream kernel
    on the chain permute, where the port runs K5 (ops/plan_gather.py); at
    10M the table is past the cap and both run it. Loss and every gradient
    on the card (K5) against the CPU (plain versions) at the same uniforms
    and noise, within 1e-4 / 1e-3 as the mono check; then on the card the
    run-aligned ELBO against the plan_convolve ELBO (harmonic_run dropped,
    whose backward is a second K5 launch): equal by construction, loss at
    rtol 1e-5 and gradients within 1e-4 of each tensor's largest entry
    (f32 sums in another order)."""
    import dataclasses

    import careless_tpu_torch.ops.plan_gather as pg
    from careless_tpu_torch import kernels
    from careless_tpu_torch.models.merging.variational import map_params
    from careless_tpu_torch.utils.params import params_to_numpy

    sizes = (50_000, 5_000, 50, D_META, N_LAYERS)
    rng = np.random.default_rng(seed + 3)
    u_f = rng.random(sizes[1]).astype(np.float32)
    eps = rng.standard_normal(sizes[0]).astype(np.float32)
    cap = pg.MAX_TABLE_ROWS
    pg.MAX_TABLE_ROWS = 64
    try:
        results, start = [], None
        for device in ("cpu", dev):
            model, params, _, inputs, _ = model_on(device, seed, *sizes,
                                                   laue=True)
            plans = inputs.plans
            check(isinstance(plans.refl, pg.ChainGatherPlan)
                  and plans.refl.inner.perm_plan.stream
                  and plans.harmonic.stream
                  and plans.harmonic_run is not None,
                  "Laue check: the plans do not stream at the lowered cap")
            if start is None:
                start = map_params(lambda a: a + 0.05 * rng.standard_normal(
                    a.shape).astype(np.float32), params_to_numpy(params))
                start["posterior"] = params_to_numpy(params["posterior"])
            kw = dict(u_f=torch.as_tensor(u_f, device=device),
                      eps=torch.as_tensor(eps, device=device))
            kernels.reset_launches()
            results.append(elbo_and_grads(torch, model, start, inputs,
                                          device, **kw))
        launches_run = kernels.LAUNCHES["gather_stream"]
        conv_inputs = dataclasses.replace(inputs, plans=dataclasses.replace(
            plans, harmonic_run=None))
        kernels.reset_launches()
        l_conv, g_conv = elbo_and_grads(torch, model, start, conv_inputs,
                                        dev, **kw)
        launches_conv = kernels.LAUNCHES["gather_stream"]
    finally:
        pg.MAX_TABLE_ROWS = cap
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    rel = abs(l_dev - l_cpu) / abs(l_cpu)
    check(rel < 1e-4, f"Laue: loss on the card {l_dev} vs CPU {l_cpu}")
    g_err = grad_rel_err(g_dev, g_cpu)
    check(g_err < 1e-3, f"Laue: gradients on the card vs CPU: rel err "
          f"{g_err}")
    check(launches_run == 1 and launches_conv == 2,
          f"Laue: gather_stream launched {launches_run} (run plan) and "
          f"{launches_conv} (plan_convolve) times, expected 1 and 2")
    rel_conv = abs(l_dev - l_conv) / abs(l_conv)
    check(rel_conv < 1e-5, f"Laue: run-plan loss {l_dev} vs plan_convolve "
          f"{l_conv} on the card")
    g_conv_err = grad_rel_err(g_dev, g_conv)
    check(g_conv_err < 1e-4, f"Laue: run-plan vs plan_convolve gradients "
          f"on the card: rel err {g_conv_err}")
    print(f"check Laue (stream at cap 64 rows): loss {l_dev:.6f} vs CPU "
          f"{l_cpu:.6f} (rel {rel:.2e}), grad rel err {g_err:.2e} over "
          f"{len(g_dev)} tensors; run plan vs plan_convolve on the card: "
          f"loss {l_dev:.6f} vs {l_conv:.6f} (rel {rel_conv:.2e}), grad rel "
          f"err {g_conv_err:.2e}; gather_stream launches {launches_run} and "
          f"{launches_conv}", flush=True)


def laue_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """The Laue slice (`careless-tpu poly` defaults) at LAUE_OBS
    observations: set-up on the host, every kernel of its step held against
    its plain version at the step's shapes and timed (K5 at the chain
    plan's own backward permute), then training; returns (K5's kernel row,
    launches over the measured run, each kernel's largest error)."""
    import careless_tpu_torch.ops.plan_gather as pg

    t0 = time.perf_counter()
    times = {}
    model, params, trainer, inputs, f_true = model_on(
        None, seed, LAUE_OBS, LAUE_REFL, LAUE_IMAGES, D_META, N_LAYERS,
        laue=True, times=times)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    refl = inputs.plans.refl
    check(isinstance(refl, pg.ChainGatherPlan),
          "Laue slice: the refl plan is not a ChainGatherPlan")
    pp = refl.inner.perm_plan
    check(pp is not None and pp.stream,
          "Laue slice: the chain plan's backward permute does not stream")
    held, perm_row = step_kernels(torch, dev, gen, inputs, "laue",
                                  peak_flops, peak_bw, "laue")
    x = torch.randn(inputs.n_obs, generator=gen, device=dev)
    row = k5_case(torch, dev, gen, x, pp.ids2d, pp.bases, pp.window,
                  pp.block_rows, refl.inner.perm, peak_flops, peak_bw,
                  f"chain permute, {inputs.n_obs} observations",
                  calls=LAUE_HOST_CALLS)
    del x
    held["gather_stream"] = row["max_abs_err"]
    launches, _, _, _, _ = train_slice(
        torch, dev, seed, model, params, trainer, inputs, f_true, STEPS_LAUE,
        CHUNK, "laue", {}, setup_s, times)
    check_launches(launches, "laue", {
        **trunk_counts(STEPS_LAUE, True, False),
        "gather": GATHERS_PER_STEP["laue"] * STEPS_LAUE,
        "philox_normal": STEPS_LAUE, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
        "gather_stream": STEPS_LAUE})
    return row, launches, held, perm_row


def step_kernels(torch, dev, gen, inputs, slice_, peak_flops, peak_bw,
                 label, frozen_scaler=False, noise_calls=(None,)):
    """Each kernel a training step on the planned `inputs` launches besides
    K5 (k5_case holds that), held against its plain version at this run's
    shapes and timed, at kernel_phase's tolerances: K1 on the inputs'
    metadata (its backward too unless frozen_scaler), K3 for the step's N
    normals (or for each of noise_calls' counts, the stacked halves' K3
    launches, at offset 0), and K2 at each (table, ids) pair of the step
    (GATHERS_PER_STEP[slice_] of them: the refl plan's, through the chain
    permute on Laue, and the image plan's, whose backward pairs a frozen
    scaler does not run; a gather that streams is K5's), on random
    tables of the step's sizes by the plans' own ids. Returns each
    kernel's largest error, and K2's row at the image cotangent's random
    permute (LAUE_PERM_PAIR; None when the scaler is frozen), on Laue the
    step's one K2 launch whose table is too large to stay in L2 beside its
    ids and output."""
    n = inputs.n_obs
    rows = trunk_rows(torch, gen, inputs.metadata, peak_flops, peak_bw,
                      backward=not frozen_scaler)
    pairs = step_pairs(inputs, slice_, label, frozen_scaler)
    gathers = {k: gather_row(torch, gen, size, ids, k, peak_flops, peak_bw,
                             calls=LAUE_HOST_CALLS)
               for k, (size, ids) in pairs.items()}
    normals = [philox_row(torch, dev, gen, n if c is None else c, 0,
                          peak_flops, peak_bw) for c in noise_calls]
    rows["philox_normal"] = max(normals, key=lambda r: r["max_abs_err"])
    print(f"{label} kernels at {n} observations: " + json.dumps(
        {**rows, "gather": gathers,
         "philox_normal_calls": normals}), flush=True)
    held = {k: v["max_abs_err"] for k, v in rows.items()}
    held["gather"] = max(v["max_abs_err"] for v in gathers.values())
    if frozen_scaler:
        return held, None
    return held, dict(gathers[LAUE_PERM_PAIR], launch_site=(
        f"{LAUE_PERM_PAIR}: one of the {label} step's "
        f"{GATHERS_PER_STEP[slice_]} K2 launches; launches counts all K2 "
        f"launches of the {label} run"))


def step_pairs(inputs, slice_, label, frozen_scaler=False):
    """The (table size, ids) of each K2 launch of a training step on the
    planned `inputs` (step_kernels' pairs), by name; checks that there are
    GATHERS_PER_STEP[slice_] of them."""
    import careless_tpu_torch.ops.plan_gather as pg

    n, plans = inputs.n_obs, inputs.plans
    refl, image = plans.refl, plans.image
    n_refl, n_images = refl.table_size, image.table_size
    chain = isinstance(refl, pg.ChainGatherPlan)
    inner = refl.inner if chain else refl
    pairs = {}
    if chain:
        pairs["z_f by sigma (forward permute)"] = (n_refl, refl.sigma)
    k5 = inner.perm_plan is not None and inner.perm_plan.stream
    # the segment sums' tables: the padded cotangent's chunks
    # (plan.chunks), and their hi and lo prefixes
    pairs.update({
        "z_f by refl_id": (n_refl, None if inner.stream else inner.ids),
        "refl cotangent by perm": (n, None if k5 else inner.perm),
        "refl segment-sum boundaries": (inner.chunks * pg._CHUNK, inner.pos),
        "refl chunk prefixes": (2 * inner.chunks, inner.cp_ids),
    })
    if chain:
        pairs["cotangent by sigma_inv (backward permute)"] = (
            n_refl, refl.sigma_inv)
    pairs["image scales by image_id"] = (n_images, image.ids)
    if not frozen_scaler:
        pairs.update({
            LAUE_PERM_PAIR: (n, image.perm),
            "image segment-sum boundaries": (image.chunks * pg._CHUNK,
                                             image.pos),
            "image chunk prefixes": (2 * image.chunks, image.cp_ids),
        })
    pairs = {k: v for k, v in pairs.items() if v[1] is not None}
    check(image.perm is not None, f"{label}: the image ids are sorted; the "
          "step has no image cotangent permute")
    check(len(pairs) == GATHERS_PER_STEP[slice_], f"{label}: {len(pairs)} "
          f"K2 pairs a step, expected {GATHERS_PER_STEP[slice_]}")
    return pairs


def scaler_slices_phase(torch, dev, seed, steps=STEPS_SCALER):
    """Train each of SCALER_SLICES at full width: each launches its own K1
    instantiation once per step in each direction and no other, and the
    image banks move; returns each instantiation's launches."""
    trunk_launches = {}
    for label, flags in SCALER_SLICES.items():
        launches, _, start, trained, _ = slice_phase(
            torch, dev, seed, steps, CHUNK, label, flags)
        head = "image_layers" not in flags
        mine = trunk_counts(steps, head, "mlp_dtype" in flags)
        check_launches(launches, label, {
            **mine, "gather": GATHERS_PER_STEP[label] * steps,
            "philox_normal": steps,
            "fused_ll_fwd": 0, "fused_ll_bwd": 0, "gather_stream": 0})
        if not head:
            moved = [float((b["w"] - a["w"]).abs().max()) for a, b in zip(
                start["scaler"]["image_layers"],
                trained["scaler"]["image_layers"])]
            check(all(math.isfinite(m) and m > 0 for m in moved),
                  f"slice {label}: the image banks did not move: {moved}")
        trunk_launches.update({k: launches[k] for k, v in mine.items() if v})
    return trunk_launches


def wide_slice_phase(torch, dev, seed):
    """The `wide` slice: the default merge with --mlp-width 128, whose K1
    runs in csrc/trunk_wide.cu (head, f32) once per step in each direction,
    K2 7 times and K3 once; prints its step time, device time, busy share
    and peak memory on lines of their own; returns the launches of every
    csrc/trunk_wide.cu instantiation over the run."""
    launches, model, _, _, out = slice_phase(
        torch, dev, seed, STEPS_WIDE, CHUNK_WIDE, "wide", WIDE_SLICE)
    check(model.scaler.mlp.width == WIDE_SLICE["mlp_width"],
          f"slice wide: MLP width {model.scaler.mlp.width}")
    check_launches(launches, "wide", {
        **trunk_counts(STEPS_WIDE, True, False, wide=True),
        "gather": GATHERS_PER_STEP["wide"] * STEPS_WIDE,
        "philox_normal": STEPS_WIDE, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
        "gather_stream": 0})
    for key in ("ms_per_step", "device_ms_per_step", "busy_share",
                "peak_mem_gb"):
        print(f"wide slice {key}: {out[key]}", flush=True)
    return {k: v for k, v in launches.items() if k.startswith("trunk_wide")}


def cli_phase(torch, dev, seed):
    """The mono merge through the port's CLI, on the card: a seeded
    unmerged MTZ (synthetic_mtz: CLI_OBS observations, CLI_IMAGES images,
    ~52k reflections, written by the port's writer under build/), then
    careless_tpu_torch.main.main(["mono", CLI_KEYS, file, out,
    "--iterations=300"]) in this process, which builds the default slice's
    model (d = w = 10, 20 layers). Checks: the five output files exist and
    read back; the merged F's correlation with the true F is at least
    CLI_MIN_CC; N sums to the observations kept (all of them: no cut asks
    to drop any); one prediction row per observation; the loss finite and
    falling; and, counted from 0 just before the call, K1 once a step each
    way plus the two K1-fwd launches of the prediction pass (scales and
    predictions), K2 GATHERS_PER_STEP["default"] a step plus the
    prediction pass's two image-scale gathers, K3 once a step, no K4 or
    K5. Prints the CLI's set-up, training and output times."""
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    t0 = time.perf_counter()
    (cols, types_), hkl_asu, f_true = synthetic_mtz(
        seed, CLI_OBS, CLI_IMAGES, CLI_CELL, CLI_SPACEGROUP, CLI_DMIN)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mtz, out = str(Path(tmp) / "unmerged.mtz"), str(Path(tmp) / "merged")
        write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                          spacegroup=SpaceGroup.from_name(CLI_SPACEGROUP),
                          mtz_dtypes=types_), mtz)
        made = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = cli_main(["mono", CLI_KEYS, mtz, out,
                          f"--iterations={CLI_STEPS}",
                          "--disable-progress-bar", f"--seed={seed}"])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        merged, preds, loss, npz = read_cli_outputs(out)
    kept = len(preds)
    check(kept == CLI_OBS, f"cli: {kept} prediction rows for {CLI_OBS} "
          "observations")
    n_sum = float(merged["N"].astype(np.float64).sum())
    check(n_sum == kept, f"cli: N sums to {n_sum}, {kept} observations")
    cc = cc_true_f("cli", merged, hkl_asu, f_true)
    check(cc >= CLI_MIN_CC, f"cli: merged F correlates {cc:.4f} with the "
          f"true F, expected at least {CLI_MIN_CC}")
    check(len(loss) == CLI_STEPS and all(map(math.isfinite, loss))
          and loss[-1] < loss[0], f"cli: loss not finite and falling: "
          f"{loss[:2]} ... {loss[-2:]}")
    check_launches(launches, "cli", {
        **{k: (CLI_STEPS + 2 if k == "trunk_fwd" else v)
           for k, v in trunk_counts(CLI_STEPS, True, False).items()},
        "gather": GATHERS_PER_STEP["default"] * CLI_STEPS + 2,
        "philox_normal": CLI_STEPS, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
        "gather_stream": 0})
    out = dict(observations=kept, reflections=len(merged), cc_true_f=cc,
               mtz_written_s=made, loss_first_last=[loss[0], loss[-1]],
               npz_keys={k: len(v) for k, v in npz.items()},
               launches={k: v for k, v in launches.items() if v})
    print("cli: " + json.dumps(out), flush=True)
    print_cli_times("cli", times, peak_gb)
    return out


def read_cli_outputs(out):
    """(merged MTZ, prediction MTZ, loss per step, npz keys) of a CLI run
    whose five files must all exist."""
    from pathlib import Path

    from careless_tpu_torch.xtal import read_mtz

    for suffix in ("_0.mtz", "_history.csv", "_predictions_0.mtz",
                   "_scale.npz", "_structure_factor.npz"):
        check(Path(out + suffix).exists(), f"cli: no {out}{suffix} written")
    with open(out + "_history.csv") as f:
        loss = [float(line.split(",")[1])
                for line in f.read().splitlines()[1:]]
    npz = {s: sorted(np.load(out + s).files)
           for s in ("_scale.npz", "_structure_factor.npz")}
    return (read_mtz(out + "_0.mtz"), read_mtz(out + "_predictions_0.mtz"),
            loss, npz)


def cc_true_f(label, merged, hkl_asu, f_true):
    """The merged F's correlation with the generator's true F, every merged
    reflection checked to be one of the generator's ASU."""
    from careless_tpu_torch.io.asu import pack_hkl

    keys = pack_hkl(hkl_asu)
    got = pack_hkl(merged.get_hkls())
    at = np.searchsorted(keys, got)
    check(np.array_equal(keys[np.minimum(at, len(keys) - 1)], got),
          f"{label}: a merged reflection is not in the generator's ASU")
    return float(np.corrcoef(merged["F"], f_true[at])[0, 1])


def print_cli_times(label, times, peak_gb):
    print(f"{label} set-up s: {times['setup_s']} (kernel build if none "
          f"{times['build_s']}, read {times['read_s']}, format "
          f"{times['format_s']}, model {times['model_s']}, plans "
          f"{times['plans_s']})", flush=True)
    print(f"{label} steps/s: {times['steps'] / times['train_s']}",
          flush=True)
    print(f"{label} output s (results, predictions, writing): "
          f"{times['output_s']}", flush=True)
    print(f"{label} peak GB: {peak_gb}", flush=True)


def poly_cli_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """The Laue merge through the port's CLI, on the card: a seeded Laue
    MTZ (synthetic_laue_mtz: POLY_SPOTS spots on POLY_IMAGES images in
    P 63, PYP's cell, to 1.6 A, band 0.95-1.25 A, 10 metadata keys;
    written by the port's writer under build/), then
    careless_tpu_torch.main.main(["poly", POLY_KEYS, file, out,
    "--iterations=300"]) in this process (d = w = 10, 20 layers; the
    expanded table passes 2,097,152 rows, so the chain permute's backward
    streams through K5). Checks: the five files exist and read back; the
    merged F's correlation with the true F is at least POLY_MIN_CC; N sums
    to the expanded rows the formatter keeps (the generator's count); one
    prediction row per harmonic group (one per spot); the loss finite and
    falling; and, counted from 0 just before the call, K1 once a step each
    way, K2 GATHERS_PER_STEP["laue"] a step, K3 and K5 once a step, no K4,
    plus the prediction pass's two K1-fwd and two image-scale K2 (the
    scaler applied once for each of the model's two moments; the group
    sums are the run plan's shifted adds, no kernel). Then the kernels of
    the path, held against their plain versions at its shapes (step_kernels and
    k5_case on the planned inputs that the same formatter and data
    manager calls give), and the "on" merge of a time-resolved pair:
    POLY_WARM_STEPS steps on the same file from --scale-file <first
    run>_scale.npz --freeze-scales, whose scale file must equal the first
    run's bit for bit, whose loss must be finite, and which launches no
    K1-bwd and IMAGE_BACKWARD_GATHERS fewer K2 a step (the frozen scales
    take no backward). Returns the launches of the first run and each held
    kernel's largest error."""
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import LaueFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    t0 = time.perf_counter()
    (cols, types_), hkl_asu, f_true, harmonics = synthetic_laue_mtz(
        seed, POLY_SPOTS, POLY_IMAGES, POLY_CELL, POLY_SPACEGROUP,
        POLY_DMIN, POLY_BAND)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mtz, out = str(Path(tmp) / "laue.mtz"), str(Path(tmp) / "off")
        write_mtz(DataSet(cols, cell=UnitCell(*POLY_CELL),
                          spacegroup=SpaceGroup.from_name(POLY_SPACEGROUP),
                          mtz_dtypes=types_), mtz)
        del cols
        made = time.perf_counter() - t0
        argv = ["poly", POLY_KEYS, mtz, out, f"--iterations={POLY_STEPS}",
                "--disable-progress-bar", f"--seed={seed}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = cli_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        merged, preds, loss, npz = read_cli_outputs(out)

        # the kernels at this path's shapes, on the inputs main() trains on
        args = cli_parser.parse_args(argv)
        inputs, rac = LaueFormatter.from_parser(args).format_files(
            [mtz], device=dev)
        planned = DataManager(inputs, rac, parser=args,
                              device=dev).planned_inputs().inputs
        del inputs
        held, _ = step_kernels(torch, dev, gen, planned, "laue", peak_flops,
                               peak_bw, "poly cli")
        pp = planned.plans.refl.inner.perm_plan
        check(pp is not None and pp.stream, "poly cli: the chain plan's "
              "backward permute does not stream")
        x = torch.randn(planned.n_obs, generator=gen, device=dev)
        held["gather_stream"] = k5_case(
            torch, dev, gen, x, pp.ids2d, pp.bases, pp.window, pp.block_rows,
            planned.plans.refl.inner.perm, peak_flops, peak_bw,
            f"poly cli chain permute, {planned.n_obs} rows",
            calls=LAUE_HOST_CALLS)["max_abs_err"]
        del x, planned

        warm = str(Path(tmp) / "on")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        warm_times = cli_main(
            ["poly", POLY_KEYS, mtz, warm, f"--iterations={POLY_WARM_STEPS}",
             "--disable-progress-bar", f"--seed={seed + 1}",
             f"--scale-file={out}_scale.npz", "--freeze-scales"])
        torch.cuda.synchronize()
        warm_launches = dict(kernels.LAUNCHES)
        warm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _, warm_preds, warm_loss, _ = read_cli_outputs(warm)
        first, second = (np.load(f"{o}_scale.npz") for o in (out, warm))
        check(first.files == second.files and all(
            first[k].tobytes() == second[k].tobytes() for k in first.files),
            "poly cli: --freeze-scales did not keep the scale file bit for "
            "bit")
    kept = int(harmonics.sum())
    check(len(preds) == POLY_SPOTS == len(warm_preds),
          f"poly cli: {len(preds)} prediction rows for {POLY_SPOTS} "
          "harmonic groups")
    n_sum = float(merged["N"].astype(np.float64).sum())
    check(n_sum == kept, f"poly cli: N sums to {n_sum}, the formatter "
          f"keeps {kept} expanded rows")
    cc = cc_true_f("poly cli", merged, hkl_asu, f_true)
    check(cc >= POLY_MIN_CC, f"poly cli: merged F correlates {cc:.4f} with "
          f"the true F, expected at least {POLY_MIN_CC}")
    check(len(loss) == POLY_STEPS and all(map(math.isfinite, loss))
          and loss[-1] < loss[0], f"poly cli: loss not finite and falling: "
          f"{loss[:2]} ... {loss[-2:]}")
    check(len(warm_loss) == POLY_WARM_STEPS
          and all(map(math.isfinite, warm_loss)),
          f"poly cli warm start: loss not finite: {warm_loss[:3]} ...")
    for label, counts, steps, frozen in (
            ("poly cli", launches, POLY_STEPS, False),
            ("poly cli warm start", warm_launches, POLY_WARM_STEPS, True)):
        per_step = {"gather": GATHERS_PER_STEP["laue"]
                    - IMAGE_BACKWARD_GATHERS * frozen, "philox_normal": 1,
                    "fused_ll_fwd": 0, "fused_ll_bwd": 0, "gather_stream": 1}
        check_launches(counts, label, {
            **{k: (steps + 2 if k == "trunk_fwd" else 0 if frozen else v)
               for k, v in trunk_counts(steps, True, False).items()},
            **{k: v * steps + 2 * (k == "gather")
               for k, v in per_step.items()}})
    multi = float((harmonics >= 2).mean())
    check(multi > 0, "poly cli: no harmonic group holds two harmonics")
    result = dict(spots=POLY_SPOTS, expanded_rows=kept,
                  multi_harmonic_group_share=multi,
                  reflections=len(merged), cc_true_f=cc,
                  mtz_written_s=made, loss_first_last=[loss[0], loss[-1]],
                  warm_loss_first_last=[warm_loss[0], warm_loss[-1]],
                  npz_keys={k: len(v) for k, v in npz.items()},
                  launches={k: v for k, v in launches.items() if v},
                  warm_launches={k: v for k, v in warm_launches.items() if v},
                  held_max_abs_err=held)
    print("poly cli: " + json.dumps(result), flush=True)
    print_cli_times("poly cli", times, peak_gb)
    print_cli_times("poly cli warm start", warm_times, warm_peak_gb)
    return launches, held


def stream_cli_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """A serial-crystallography merge from a CrystFEL stream through the
    port's CLI, on the card: a seeded stream (synthetic_stream:
    STREAM_REFL reflections of STREAM_CRYSTALS crystals in P 43 21 2 to
    2.0 A, written under build/), then careless_tpu_torch.main.main(
    ["mono", STREAM_KEYS, file, out, "--spacegroups=P 43 21 2",
    "--iterations=300"]) in this process: the stream read by the port's
    native parser (xtal/_native.py, built at its first use, in build_s),
    d = w = 5 (the five stream metadata keys), 20 layers, with
    mono_cli_merge's checks (one prediction row per reflection, the merged
    F's correlation with the true F at least STREAM_MIN_CC, the launches)
    and its kernels held at the path's shapes; and the CLI reports the
    native parser. Then the native parser held against the Python
    reader (_read_crystfel_python) on a seeded stream of STREAM_CHECK_REFL
    reflections: the integer and intensity columns equal, the geometry
    within STREAM_GEOMETRY_ULPS ulps of f32, the cell equal. Prints the
    parser and the read seconds on the phase's line, both parse times of
    the check, and the read among the set-up parts. Returns the launches
    and each held kernel's largest error."""
    import tempfile
    from pathlib import Path

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        stream, out = str(Path(tmp) / "sim.stream"), str(Path(tmp) / "xfel")
        t0 = time.perf_counter()
        hkl_asu, f_true = synthetic_stream(
            seed, stream, STREAM_REFL, STREAM_CRYSTALS, STREAM_CELL,
            STREAM_SPACEGROUP, STREAM_DMIN)
        made = time.perf_counter() - t0
        argv = ["mono", STREAM_KEYS, stream, out,
                f"--spacegroups={STREAM_SPACEGROUP}",
                f"--iterations={STREAM_STEPS}", "--disable-progress-bar",
                f"--seed={seed}"]
        times, launches, peak_gb, merge = mono_cli_merge(
            torch, dev, gen, argv, STREAM_STEPS, "stream cli", STREAM_REFL,
            hkl_asu, f_true, STREAM_MIN_CC, peak_flops, peak_bw)
        parsers = parser_check(seed, str(Path(tmp) / "check.stream"))
    check(times.get("read_parser") == "native", f"stream cli: the stream "
          f"was read by the {times.get('read_parser')} parser, not the "
          "native one")
    result = dict(reflections_in=STREAM_REFL, crystals=STREAM_CRYSTALS,
                  stream_written_s=made, read_s=times["read_s"],
                  read_parser=times["read_parser"], **merge)
    print("stream cli: " + json.dumps(result), flush=True)
    print("stream cli parsers: " + json.dumps(parsers), flush=True)
    print_cli_times("stream cli", times, peak_gb)
    return launches, merge["held_max_abs_err"]


def mono_cli_merge(torch, dev, gen, argv, steps, label, n_rows, hkl_asu,
                   f_true, min_cc, peak_flops, peak_bw):
    """The mono merge `argv` (["mono", keys, file, out, ...] with
    --iterations=`steps`) through the port's CLI on the card, in this
    process, the launches counted from 0 just before main(); then the
    path's kernels held against their plain versions at its shapes
    (step_kernels on the planned inputs that the same formatter and data
    manager calls give). Checks: the five files; one prediction row per
    input row (n_rows); N sums to them; the merged F's correlation with
    the true F at least min_cc; the loss finite and falling; the launches
    of cli_counts(steps): K1 once a step each way (plus the prediction
    pass's two K1-fwd), K2 GATHERS_PER_STEP["default"] a step (plus two),
    K3 once a step, no K4 or K5. Returns (the CLI's times, the launches,
    peak GB, the merge's fields of the phase's line)."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.parser import parser as cli_parser

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = cli_main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    merged, preds, loss, npz = read_cli_outputs(argv[3])

    args = cli_parser.parse_args(argv)
    inputs, rac = MonoFormatter.from_parser(args).format_files(
        [argv[2]], device=dev)
    planned = DataManager(inputs, rac, parser=args,
                          device=dev).planned_inputs().inputs
    del inputs
    held, _ = step_kernels(torch, dev, gen, planned, "default", peak_flops,
                           peak_bw, label)
    del planned
    check(len(preds) == n_rows, f"{label}: {len(preds)} prediction rows "
          f"for {n_rows} reflections")
    n_sum = float(merged["N"].astype(np.float64).sum())
    check(n_sum == n_rows, f"{label}: N sums to {n_sum}")
    cc = cc_true_f(label, merged, hkl_asu, f_true)
    check(cc >= min_cc, f"{label}: merged F correlates {cc:.4f} with the "
          f"true F, expected at least {min_cc}")
    check(len(loss) == steps and all(map(math.isfinite, loss))
          and loss[-1] < loss[0], f"{label}: loss not finite and falling: "
          f"{loss[:2]} ... {loss[-2:]}")
    check_launches(launches, label, cli_counts(steps))
    return times, launches, peak_gb, dict(
        merged_reflections=len(merged), cc_true_f=cc,
        loss_first_last=[loss[0], loss[-1]],
        npz_keys={k: len(v) for k, v in npz.items()},
        launches={k: v for k, v in launches.items() if v},
        held_max_abs_err=held)


def f32_ulps(a, b):
    """The largest distance between two f32 arrays in units in the last
    place (+0 and -0 at distance 0)."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32)
        i = i.astype(np.int64)
        return np.where(i < 0, -(2 ** 31) - i, i)
    return int(np.abs(key(a) - key(b)).max(initial=0))


def parser_check(seed, path):
    """The port's read_crystfel (the native parser) against its Python
    reader on a seeded stream of STREAM_CHECK_REFL reflections written to
    `path`: the integer and intensity columns equal, the geometry columns
    within STREAM_GEOMETRY_ULPS ulps, the cell equal. Returns both parse
    times and the geometry's largest ulp distance."""
    from careless_tpu_torch.xtal import stream as port_stream

    synthetic_stream(seed + 1, path, STREAM_CHECK_REFL,
                     STREAM_CHECK_CRYSTALS, STREAM_CELL, STREAM_SPACEGROUP,
                     STREAM_DMIN)
    t0 = time.perf_counter()
    native = port_stream.read_crystfel(path)
    t1 = time.perf_counter()
    python = port_stream._read_crystfel_python(path)
    t2 = time.perf_counter()
    check(port_stream.last_parser == "native", "stream parsers: "
          f"read_crystfel took the {port_stream.last_parser} parser")
    check(native.columns == python.columns and len(native) == len(python)
          == STREAM_CHECK_REFL, f"stream parsers: {len(native)} and "
          f"{len(python)} rows of {STREAM_CHECK_REFL}, columns "
          f"{native.columns} and {python.columns}")
    geometry = ("s1x", "s1y", "s1z", "ewald_offset", "angular_ewald_offset",
                "Wavelength")
    for c in native.columns:
        if c not in geometry:
            check(native[c].dtype == python[c].dtype
                  and np.array_equal(native[c], python[c]),
                  f"stream parsers: column {c} differs")
    ulps = max(f32_ulps(native[c], python[c]) for c in geometry)
    check(ulps <= STREAM_GEOMETRY_ULPS, f"stream parsers: the geometry "
          f"differs by {ulps} ulps, more than {STREAM_GEOMETRY_ULPS}")
    check(native.cell.parameters == python.cell.parameters,
          f"stream parsers: cells {native.cell.parameters} and "
          f"{python.cell.parameters}")
    return dict(reflections=STREAM_CHECK_REFL, native_parse_s=t1 - t0,
                python_parse_s=t2 - t1, geometry_max_ulps=ulps)


def stills_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """A serial-crystallography merge of DIALS stills through the port's
    stills2mtz and CLI, on the card: a seeded stills table and experiment
    list (synthetic_stills: STILLS_REFL reflections on STILLS_STILLS stills
    in P 1 21 1 to 1.8 A, every optional column, no negative variance,
    written under build/) converted by careless_tpu_torch.scripts.stills2mtz
    under dials_stand_in (a stand-in for DIALS, not DIALS: the table's
    columns as an .npz), then careless_tpu_torch.main.main(["mono",
    STILLS_KEYS, mtz, out, "--spacegroups=P 1 21 1", "--iterations=300"])
    in this process (d = w = 8, 20 layers). Checks: the converted file's
    rows and columns, SigI finite; then mono_cli_merge's (one prediction
    row per reflection, the merged F's correlation with the true F at
    least STILLS_MIN_CC, the launches), with the path's kernels held
    against their plain versions at its shapes. Prints the
    conversion's seconds and the card on the phase's line, set-up by part,
    steps/s, output seconds and peak GB. Returns the launches and each
    held kernel's largest error."""
    import tempfile
    from pathlib import Path

    from careless_tpu_torch.scripts import stills2mtz

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        refl, expt, mtz, out = (str(Path(tmp) / n) for n in (
            "stills.refl", "stills.expt", "stills.mtz", "sfx"))
        t0 = time.perf_counter()
        hkl_asu, f_true = synthetic_stills(
            seed, refl, expt, STILLS_REFL, STILLS_STILLS, STILLS_CELL,
            STILLS_SPACEGROUP, STILLS_DMIN, negative=0)
        made = time.perf_counter() - t0
        with dials_stand_in():
            t0 = time.perf_counter()
            converted = stills2mtz.run(stills2mtz.ArgumentParser().parse_args(
                [refl, expt, "-o", mtz]))
            convert_s = time.perf_counter() - t0
        check(len(converted) == STILLS_REFL and len(converted.columns) == 20
              and set(STILLS_KEYS.split(",")[1:]) <= set(converted.columns)
              and np.isfinite(converted["SigI"]).all(), "stills: the "
              f"converted file has {len(converted)} rows and columns "
              f"{converted.columns}, or a SigI not finite")
        del converted
        argv = ["mono", STILLS_KEYS, mtz, out,
                f"--spacegroups={STILLS_SPACEGROUP}",
                f"--iterations={STILLS_STEPS}", "--disable-progress-bar",
                f"--seed={seed}"]
        times, launches, peak_gb, merge = mono_cli_merge(
            torch, dev, gen, argv, STILLS_STEPS, "stills", STILLS_REFL,
            hkl_asu, f_true, STILLS_MIN_CC, peak_flops, peak_bw)
    result = dict(card=card_line(), reflections_in=STILLS_REFL,
                  stills=STILLS_STILLS, stills_written_s=made,
                  convert_s=convert_s, **merge)
    print("stills (the conversion under a DIALS stand-in): "
          + json.dumps(result), flush=True)
    print_cli_times("stills", times, peak_gb)
    return launches, merge["held_max_abs_err"]


# the resume phase: B trains RESUME_STEPS steps and writes a checkpoint;
# A (uninterrupted) and C (B resumed) train twice as many; all three hold
# out RESUME_FRACTION of the rows, scored every RESUME_VALIDATION steps
RESUME_STEPS, RESUME_FRACTION, RESUME_VALIDATION = 100, 0.1, 10


def resume_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """Checkpoints, resume and the held-out test fraction through the
    port's CLI, on the card, at the CLI phase's width (synthetic_mtz's
    CLI_OBS observations, the default model: d = w = 10, 20 layers): three
    runs of careless_tpu_torch.main.main(["mono", CLI_KEYS, file, out,
    "--test-fraction=0.1", "--validation-frequency=10"]) in this process,
    A for 2 R steps, B for R with --checkpoint-every=R, C from B's
    checkpoint (--resume-from) to 2 R. Checks: C's _scale.npz,
    _structure_factor.npz, merged and prediction MTZs and history equal
    A's bit for bit; the prediction file holds the train rows with test = 0
    and then exactly the held-out rows of DataManager.split_data_by_refl
    for the seed (formatted here on the CPU) with test = 1; NLL_val finite,
    its last value below its first; each run's launches, counted from 0
    just before it: its steps', plus a K1-fwd, two K2 and a K3 for each
    validation pass, plus two K1-fwd and two K2 for each of the two
    prediction passes (train and held-out rows). Prints the checkpoint's
    size and write time, and each run's set-up, steps/s (validation
    included) and output seconds; the merged F's correlation with the true
    F is printed, not gated (a tenth of the rows is held out). Then the
    kernels of the path, held against their plain versions at its shapes
    (step_kernels) on the planned train rows, which the steps run, and on
    the planned held-out rows, which the validation passes run at a tenth
    of the size (K1-fwd's grid there is smaller than the card's SMs) and
    whose K2 gathers through a sparse refl plan into the whole table: both
    copies made by the formatter and data manager calls that main() makes.
    Returns {"resume_train": errors, "resume_test": errors}, each held
    kernel's largest error on that copy."""
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.utils import checkpoint
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         read_mtz, write_mtz)

    R = RESUME_STEPS
    (cols, types_), hkl_asu, f_true = synthetic_mtz(
        seed, CLI_OBS, CLI_IMAGES, CLI_CELL, CLI_SPACEGROUP, CLI_DMIN)
    writes = []
    save_state = checkpoint.save_state

    def timed_save_state(*args, **kw):
        t0 = time.perf_counter()
        save_state(*args, **kw)
        writes.append(time.perf_counter() - t0)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    result, runs = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mtz = str(Path(tmp) / "unmerged.mtz")
        write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                          spacegroup=SpaceGroup.from_name(CLI_SPACEGROUP),
                          mtz_dtypes=types_), mtz)
        argv = ["mono", CLI_KEYS, mtz, None, "--disable-progress-bar",
                f"--seed={seed}", f"--test-fraction={RESUME_FRACTION}",
                f"--validation-frequency={RESUME_VALIDATION}"]
        out = {k: str(Path(tmp) / k) for k in "ABC"}
        plan = {"A": (0, 2 * R, []),
                "B": (0, R, [f"--checkpoint-every={R}"]),
                "C": (R, 2 * R, [f"--resume-from={out['B']}_checkpoint"])}
        checkpoint.save_state = timed_save_state
        try:
            for name, (start, steps, extra) in plan.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                times = cli_main(argv[:3] + [out[name]] + argv[4:]
                                 + [f"--iterations={steps}", *extra])
                torch.cuda.synchronize()
                runs[name] = (dict(kernels.LAUNCHES), times, steps - start,
                              torch.cuda.max_memory_allocated() / 1e9)
        finally:
            checkpoint.save_state = save_state
        ckpt = Path(out["B"] + "_checkpoint.npz")
        check(ckpt.exists() and len(writes) == 1,
              f"resume: {len(writes)} checkpoint writes, expected B's one")
        with np.load(ckpt) as f:
            check(int(f["__step__"]) == R and str(f["rng/device_type"])
                  == dev.type, "resume: B's checkpoint is not at step "
                  f"{R} on a {dev.type} generator")
        result["checkpoint_mb"] = ckpt.stat().st_size / 1e6
        result["checkpoint_write_s"] = writes[0]
        for suffix in ("_scale.npz", "_structure_factor.npz"):
            a, c = (np.load(out[k] + suffix) for k in "AC")
            check(a.files == c.files and all(
                a[k].tobytes() == c[k].tobytes() for k in a.files),
                f"resume: C's {suffix} is not A's bit for bit")
        for suffix in ("_0.mtz", "_predictions_0.mtz"):
            a, c = (read_mtz(out[k] + suffix) for k in "AC")
            check(a.columns == c.columns and all(
                a[k].tobytes() == c[k].tobytes() for k in a.columns),
                f"resume: C's {suffix} is not A's bit for bit")
        history = [Path(out[k] + "_history.csv").read_text() for k in "AC"]
        check(history[0] == history[1],
              "resume: C's history is not A's bit for bit")
        merged, preds, loss, _ = read_cli_outputs(out["A"])
        with open(out["A"] + "_history.csv") as f:
            rows = f.read().splitlines()
        at = rows[0].split(",").index("NLL_val")
        val = [float(r.split(",")[at]) for r in rows[1:]]
        args = cli_parser.parse_args(argv[:3] + ["x"] + argv[4:])
        inputs, rac = MonoFormatter.from_parser(args).format_files(
            [mtz], device=dev)
        dm = DataManager(inputs, rac, parser=args, device=dev)
        del inputs
        train, test = dm.split_data_by_refl(RESUME_FRACTION)
        held = {}
        for label, half in (("train", train), ("test", test)):
            planned = dm.planned_inputs(half).inputs
            held[f"resume_{label}"], _ = step_kernels(
                torch, dev, gen, planned, "default", peak_flops, peak_bw,
                f"resume {label}")
            del planned
        del dm
    flag = preds["test"]
    n_test = int(flag.sum())
    check(n_test == test.n_obs and len(flag) == train.n_obs + test.n_obs
          and not flag[:train.n_obs].any(),
          f"resume: {n_test} of {len(flag)} prediction rows held out, "
          f"expected the split's {test.n_obs} last")
    check(np.array_equal(preds["Iobs"][train.n_obs:],
                         test.intensities.cpu().numpy())
          and np.array_equal(preds["image_id"][train.n_obs:],
                             test.image_id.cpu().numpy()),
          "resume: the held-out prediction rows are not the split's")
    check(len(val) == 2 * R and all(map(math.isfinite, val))
          and val[-1] < val[0],
          f"resume: NLL_val not finite and falling: {val[:1]} ... "
          f"{val[-1:]}")
    check(float(merged["N"].astype(np.float64).sum()) == train.n_obs,
          "resume: N does not count the train rows")
    for name, (launches, times, steps, _) in runs.items():
        check_launches(launches, f"resume {name}", cli_counts(
            steps, passes=-(-steps // RESUME_VALIDATION), predictions=2))
    result.update(
        steps=R, held_out_rows=test.n_obs, train_rows=train.n_obs,
        nll_val_first_last=[val[0], val[-1]],
        loss_first_last=[loss[0], loss[-1]],
        cc_true_f_not_gated=cc_true_f("resume", merged, hkl_asu, f_true),
        launches={k: {n: v for n, v in r[0].items() if v}
                  for k, r in runs.items()},
        held_max_abs_err=held)
    print("resume: " + json.dumps(result), flush=True)
    for name, (_, times, steps, peak_gb) in runs.items():
        print_cli_times(f"resume {name} ({steps} steps)",
                        dict(times, steps=steps), peak_gb)
    return held

@contextlib.contextmanager
def counted_half_merges(torch, seen):
    """Within it, careless_tpu_torch.main's half merges are counted apart
    from the main run: when they start, seen["main"] takes
    kernels.LAUNCHES (the main run's, from the caller's reset) and the
    counts are set to 0; when they end, seen["xval"] takes theirs, and
    seen["scaler_kept"] says whether the main run's scaler came out of
    them bit for bit."""
    import careless_tpu_torch.main as cli
    from careless_tpu_torch import kernels
    from careless_tpu_torch.models.merging.variational import flatten_params

    crossvalidate = cli.run_half_dataset_crossvalidation

    def counted(dm, trained, parser, device):
        torch.cuda.synchronize()
        seen["main"] = dict(kernels.LAUNCHES)
        before = [t.clone() for _, t in flatten_params(trained["scaler"])]
        kernels.reset_launches()
        times = crossvalidate(dm, trained, parser, device)
        torch.cuda.synchronize()
        seen["xval"] = dict(kernels.LAUNCHES)
        seen["scaler_kept"] = all(torch.equal(a, b) for a, (_, b) in zip(
            before, flatten_params(trained["scaler"])))
        return times

    cli.run_half_dataset_crossvalidation = counted
    try:
        yield seen
    finally:
        cli.run_half_dataset_crossvalidation = crossvalidate


# half-dataset crossvalidation on the cli cell's MTZ: steps of the main run
# and of every half, and repeats (K = 2 x repeats halves)
XVAL_STEPS, XVAL_REPEATS = 100, 2
XVAL_MODES = ("serial", "parallel")


def xval_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """Half-dataset crossvalidation through the port's CLI, on the card:
    the cli phase's MTZ (synthetic_mtz, CLI_OBS observations) merged by
    careless_tpu_torch.main.main(["mono", CLI_KEYS, file, out,
    "--iterations=100", "--merge-half-datasets", "--half-dataset-repeats=2",
    "--xval-mode=<mode>"]) in this process, once in each mode. Checks: the
    _xval_0.mtz of each holds (repeat, half) in {0, 1}^2, each half's N
    summing to its rows (the halves DataManager.split_data_by_image draws
    for the seed, formatted here) and each repeat's to every observation;
    the two forms' rows equal, their F and SigF within rtol 1e-3 / atol
    1e-3 (the JAX package's bar for its own two forms), the largest
    differences printed, and every column bit for bit (each half's
    gradient summed in its serial order); the main run's scaler the same
    before and after the half merges, bit for bit, and both runs' scale
    files equal; the main
    run's loss finite and falling; the launches, counted from 0 just before
    the CLI call up to the half merges (the cli phase's counts at these
    steps) and from 0 just before the half merges to their end: serial,
    per half and step K1-fwd 1, K2 GATHERS_PER_STEP["xval"] and K3 1; the
    parallel form per step K1-fwd 1 for all halves, K2 as one merge
    (GATHERS_PER_STEP["xval"]) and K3 once per half; never K1-bwd (the
    scaler is frozen), K4 or K5. Then the half path's kernels held against
    their plain versions at each form's shapes (step_kernels, K1 forward
    only: on the parallel form's stacked planned rows with its blocked
    refl plan, K3 at each half's rows; and on the serial form's first half,
    planned alone). Prints each form's set-up, seconds of half merging and
    steps/s (steps of all halves, and half-steps). Returns the held
    kernels' errors by form ("xval", "xval_serial")."""
    import tempfile
    from pathlib import Path

    import careless_tpu_torch.main as cli
    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.parallel.xval import stack_halves
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         read_mtz, write_mtz)

    S, K = XVAL_STEPS, 2 * XVAL_REPEATS
    (cols, types_), hkl_asu, f_true = synthetic_mtz(
        seed, CLI_OBS, CLI_IMAGES, CLI_CELL, CLI_SPACEGROUP, CLI_DMIN)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mtz = str(Path(tmp) / "unmerged.mtz")
        write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                          spacegroup=SpaceGroup.from_name(CLI_SPACEGROUP),
                          mtz_dtypes=types_), mtz)
        del cols
        argv = ["mono", CLI_KEYS, mtz, None, f"--iterations={S}",
                "--disable-progress-bar", f"--seed={seed}",
                "--merge-half-datasets",
                f"--half-dataset-repeats={XVAL_REPEATS}"]
        for mode in XVAL_MODES:
            seen = {}
            out = str(Path(tmp) / mode)
            with counted_half_merges(torch, seen):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                times = cli.main(argv[:3] + [out] + argv[4:]
                                 + [f"--xval-mode={mode}"])
                torch.cuda.synchronize()
            _, _, loss, _ = read_cli_outputs(out)
            with np.load(out + "_scale.npz") as f:
                scale = {k: f[k] for k in f.files}
            runs[mode] = dict(times=times, seen=seen, loss=loss, scale=scale,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              xval=read_mtz(out + "_xval_0.mtz"))

        # the halves main() drew, and the parallel step's kernels
        args = cli_parser.parse_args(argv[:3] + ["x"] + argv[4:])
        inputs, rac = MonoFormatter.from_parser(args).format_files(
            [mtz], device=dev)
        dm = DataManager(inputs, rac, parser=args, device=dev)
        del inputs
        halves = [h for _ in range(XVAL_REPEATS)
                  for h in dm.split_data_by_image()]
        half_rows = [h.n_obs for h in halves]
        stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                               dm.n_refl, dm.n_images)
        held = {"xval": step_kernels(
            torch, dev, gen, stacked.inputs, "xval", peak_flops, peak_bw,
            "xval parallel", frozen_scaler=True, noise_calls=half_rows)[0]}
        del stacked
        # the serial form's first half: its own rows, plans and K3 call
        held["xval_serial"], _ = step_kernels(
            torch, dev, gen, dm.planned_inputs(halves[0]).inputs, "xval",
            peak_flops, peak_bw, "xval serial half 0", frozen_scaler=True)
        del halves, dm
    result = dict(halves=K, half_rows=half_rows, steps=S)
    for mode, run in runs.items():
        ds, seen, loss = run["xval"], run["seen"], run["loss"]
        check(seen["scaler_kept"], f"xval {mode}: the half merges changed "
              "the main run's scaler")
        check(len(loss) == S and all(map(math.isfinite, loss))
              and loss[-1] < loss[0], f"xval {mode}: the main run's loss "
              f"not finite and falling: {loss[:2]} ... {loss[-2:]}")
        tags = sorted(set(zip(ds["repeat"].tolist(), ds["half"].tolist())))
        check(tags == [(r, h) for r in (0, 1) for h in (0, 1)]
              and ds.mtz_dtypes["repeat"] == ds.mtz_dtypes["half"] == "I",
              f"xval {mode}: (repeat, half) {tags}")
        n = [float(ds["N"][(ds["repeat"] == r) & (ds["half"] == h)]
                   .astype(np.float64).sum()) for r, h in tags]
        check(n == half_rows, f"xval {mode}: N sums to {n} by half, the "
              f"halves hold {half_rows} rows")
        check_launches(seen["main"], f"xval {mode} main run", cli_counts(S))
        check_launches(seen["xval"], f"xval {mode} half merges",
                       half_merge_counts(S, K, K if mode == "serial" else 1))
        t = run["times"]
        result[mode] = dict(
            setup_s=t["xval_setup_s"], merging_s=t["xval_train_s"],
            steps_per_s=S / t["xval_train_s"],
            half_steps_per_s=K * S / t["xval_train_s"],
            output_s=t["xval_output_s"],
            main_steps_per_s=t["steps"] / t["train_s"],
            main_setup_s=t["setup_s"], peak_gb=run["peak_gb"],
            launches={k: v for k, v in seen["xval"].items() if v})
    a, b = (runs[m]["xval"] for m in XVAL_MODES)
    check(all(np.array_equal(a[c], b[c])
              for c in ("H", "K", "L", "repeat", "half", "N")),
          "xval: the two forms' rows differ")
    for c in ("F", "SigF"):
        diff = np.abs(a[c] - b[c])
        result[f"{c}_max_abs_diff"] = float(diff.max())
        result[f"{c}_max_rel_diff"] = float((diff / np.abs(a[c])).max())
        check(bool(np.all(diff <= 1e-3 + 1e-3 * np.abs(b[c]))),
              f"xval: the forms' {c} differ past rtol 1e-3 / atol 1e-3: "
              f"{diff.max()}")
    # the parallel form sums each half's gradient in its serial order
    # (parallel/xval.py), so every column agrees bit for bit
    check(a.columns == b.columns and all(
        a[c].tobytes() == b[c].tobytes() for c in a.columns),
        "xval: the two forms' _xval_0.mtz differ in their bits")
    scales = [runs[m]["scale"] for m in XVAL_MODES]
    check(scales[0].keys() == scales[1].keys() and all(
        np.array_equal(scales[0][k], scales[1][k]) for k in scales[0]),
        "xval: the two runs' main merges wrote different scale files")
    result["cc_true_f_by_half"] = [
        cc_true_f("xval", a.select((a["repeat"] == r) & (a["half"] == h)),
                  hkl_asu, f_true) for r in (0, 1) for h in (0, 1)]
    print("xval: " + json.dumps(result), flush=True)
    for mode in XVAL_MODES:
        r = result[mode]
        print(f"xval {mode}: set-up s {r['setup_s']}, half merging s "
              f"{r['merging_s']}, steps/s {r['steps_per_s']} (half-steps/s "
              f"{r['half_steps_per_s']}), output s {r['output_s']}",
              flush=True)
    return held


# the shard phase: the default slice's problem trained SHARD_STEPS steps
# through the sharded Trainer (parallel/shard.py) at one NCCL rank, then at
# two gloo ranks on one card on the observation axis, on the Monte Carlo
# axis at --mc-samples=2, and on a Laue problem of SHARD_LAUE_OBS rows whose
# chain permute streams in each shard (the table cap lowered to
# SHARD_LAUE_CAP rows of 128); every run against the same run unsharded
SHARD_STEPS, SHARD_CHUNK = 100, 50
SHARD_WORLD = 2
SHARD_LAUE_OBS, SHARD_LAUE_REFL, SHARD_LAUE_IMAGES = 2_000_000, 100_000, 4_000
SHARD_LAUE_CAP = 4096
# the step-0 key and generator seed of the gradient check (step_zero)
SHARD_KEY = 12345 | (7 << 32)
# the merged F of each two-rank run after SHARD_STEPS steps against the
# unsharded run's, least correlation: the ranks sum the same f32 terms in
# another order, so the runs part by rounding only
SHARD_MIN_CORR = 0.9999


def shard_config(seed, card=True, mono=None, laue=None, steps=SHARD_STEPS,
                 chunk=SHARD_CHUNK, mc_flags=None, laue_cap=SHARD_LAUE_CAP):
    """What shard_rank and shard_reference run: the problem sizes (n_obs,
    n_refl, n_images, d_meta, n_layers) of the mono runs and the Laue
    run, the steps, the flags of the mc run, and whether to hold the
    kernels (the card)."""
    return dict(
        seed=seed, card=card, steps=steps, chunk=chunk, laue_cap=laue_cap,
        mono=mono or (N_OBS, N_REFL, N_IMAGES, D_META, N_LAYERS),
        laue=laue or (SHARD_LAUE_OBS, SHARD_LAUE_REFL, SHARD_LAUE_IMAGES,
                      D_META, N_LAYERS),
        mc_flags=mc_flags or SLICE_A)


def shard_runs(cfg):
    """(label, problem sizes, flags, laue, axis) of each run."""
    return (("obs", cfg["mono"], {}, False, "obs"),
            ("mc", cfg["mono"], cfg["mc_flags"], False, "mc"),
            ("laue", cfg["laue"], {}, True, "obs"))


@contextlib.contextmanager
def table_cap(rows):
    """ops/plan_gather.MAX_TABLE_ROWS lowered to `rows` within (None:
    left as it is)."""
    import careless_tpu_torch.ops.plan_gather as pg

    cap = pg.MAX_TABLE_ROWS
    if rows is not None:
        pg.MAX_TABLE_ROWS = rows
    try:
        yield
    finally:
        pg.MAX_TABLE_ROWS = cap


def step_zero(torch, trainer, params, inputs, seed, shard=None):
    """(loss, every gradient on the CPU) of Trainer.step_gradients at
    `params`, the generator seeded with `seed` and the key SHARD_KEY: the
    sharded step's gradients after the all_reduce, or the unsharded
    step's."""
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.merging.variational import (
        flatten_params, map_params)

    p = map_params(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = [t for _, t in flatten_params(p)]
    grads, _, metrics = trainer.step_gradients(
        p, leaves, [False] * len(leaves), inputs,
        seeded_generator(seed, inputs.device), SHARD_KEY, shard)
    return metrics["loss"].item(), [g.detach().cpu() for g in grads]


def shard_run(torch, device, cfg, run, rank=0, world=None):
    """One of shard_runs trained cfg["steps"] steps on `device`: unsharded
    (world None) or as rank `rank` of `world` in the default process
    group. Returns its step-0 loss and gradients (step_zero), trained
    parameters (numpy, flatten_params order), history, ms a step, the
    launches of its training and its rows; on the card also the kernels
    held at its shapes (hold_shard_kernels) and, sharded, the time of an
    all_reduce of its flat gradient buffer."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.parallel.shard import sample_shard, shard_inputs

    label, sizes, flags, laue, axis = run
    seed = cfg["seed"]
    with table_cap(cfg["laue_cap"] if laue else None):
        t0 = time.perf_counter()
        model, params, trainer, layout, f_true = model_on(
            device, seed, *sizes, flags=flags, laue=laue, plans=False)
        n_refl, n_images = len(f_true), sizes[2]
        shard = None
        if world is None or axis == "mc":
            inputs = layout.with_plans(n_refl, n_images)
            if world is not None:
                shard = sample_shard(model.mc_samples, rank, world,
                                     inputs.n_obs)
        else:
            inputs, shard = shard_inputs(layout, rank, world, n_refl,
                                         n_images)
        del layout
        setup_s = time.perf_counter() - t0
        out = dict(label=label, n_local=inputs.n_obs, setup_s=setup_s,
                   row_offset=0 if shard is None else shard.row_offset,
                   samples=None if shard is None else shard.samples,
                   fused_kernel=model.fused_kernel)
        out["loss0"], out["grads0"] = step_zero(torch, trainer, params,
                                                inputs, seed, shard)
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda: None))
        if cfg["card"]:
            trainer.train(params, seeded_generator(seed + 100, device),
                          inputs, 5, chunk_size=5, device=device, shard=shard)
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trained, history = trainer.train(
            params, seeded_generator(seed, device), inputs, cfg["steps"],
            chunk_size=cfg["chunk"], device=device, shard=shard)
        sync()
        out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / cfg["steps"]
        out["launches"] = dict(kernels.LAUNCHES)
        out["history"] = history
        out["params"] = [t.cpu().numpy() for _, t in flatten_params(trained)]
        out["f_mean"] = model.posterior.distribution(
            trained["posterior"]).mean().cpu().numpy()
        out["corr_f_true"] = float(np.corrcoef(out["f_mean"], f_true)[0, 1])
        if cfg["card"]:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed + 7 + rank)
            out["held"] = hold_shard_kernels(torch, device, gen, inputs,
                                             model, shard, label)
            if shard is not None:
                out["all_reduce_ms"] = all_reduce_ms(
                    torch, sum(p.size for p in out["params"]) + 1, device)
    return out


def all_reduce_ms(torch, n, device, reps=50):
    """Milliseconds of one all_reduce (SUM) of an (n,) f32 buffer on
    `device` over the default group, the mean of `reps` after 5."""
    from careless_tpu_torch.parallel.distributed import all_reduce_sum

    buf = torch.ones(n, device=device)
    for _ in range(5):
        all_reduce_sum(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_sum(buf)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def shard_rank(rank, world, device, cfg):
    """A rank of the shard phase (distributed.spawn's target): each of
    shard_runs as rank `rank` of `world`; returns their shard_run
    results."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [shard_run(torch, device, cfg, run, rank, world)
            for run in shard_runs(cfg)]


def shard_reference(torch, device, cfg):
    """Each of shard_runs unsharded on `device` (shard_run)."""
    return [shard_run(torch, device, cfg, run) for run in shard_runs(cfg)]


def halves_case(device, seed, n_obs, n_refl, n_images, d_meta, n_layers,
                repeats=XVAL_REPEATS):
    """The parallel crossvalidation of build_problem's mono problem as the
    CLI sets it up: (the trainer with the scaler frozen, the initial
    params, each half's generator seed, each half's planned rows, n_refl,
    n_images), the 2 x repeats halves drawn by
    DataManager.split_data_by_image for the seed."""
    import dataclasses

    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.models.base import Inputs
    from careless_tpu_torch.parallel.xval import make_half_keys

    arrays, asu, _ = build_problem(seed, n_obs, n_refl, n_images, d_meta)
    parser = types.SimpleNamespace(**{**MONO_DEFAULTS, "seed": seed,
                                      "mlp_layers": n_layers})
    dm = DataManager(Inputs.from_arrays(*arrays, device=device), asu, parser,
                     device=device)
    _, params, trainer = dm.build_model()
    halves = [h for _ in range(repeats) for h in dm.split_data_by_image()]
    return (dataclasses.replace(trainer, freeze=("scaler",)), params,
            make_half_keys(seed, repeats),
            [dm.planned_rows(h).inputs for h in halves], dm.n_refl,
            dm.n_images)


def halves_rank(rank, world, device, seed, sizes, steps):
    """A rank of train_halves_spread on halves_case(device, seed, *sizes)
    (distributed.spawn's target): the whole trained tree as numpy, in
    flatten_params order, and the history."""
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.parallel.xval import train_halves_spread

    trainer, params, seeds, rows, n_refl, n_images = halves_case(
        device, seed, *sizes)
    trained, history = train_halves_spread(trainer, params, seeds, rows,
                                           n_refl, n_images, steps,
                                           chunk_size=steps, device=device)
    return [t.cpu().numpy() for _, t in flatten_params(trained)], history


def hold_shard_kernels(torch, dev, gen, inputs, model, shard, label):
    """Each kernel a step on this rank's `inputs` launches, held against its
    plain version at its shapes, untimed: K1 both ways on the inputs'
    metadata (a random trunk of the model's depth, 1e-4 of the output scale
    and of each gradient's largest entry), K2 at each of the step's
    (table, ids) pairs (bit for bit), K3 at each of this rank's sample
    offsets s n_total + row_offset (words bit for bit, normals within
    2e-5), K4 both ways at those offsets where the model is fused (the sum
    within 1e-5 of the sum of |ll|, each gradient within 1e-5 of its
    tensor's largest entry), and K5 at the chain plan's streamed backward
    permute (bit for bit). Returns each kernel's largest error by
    kernels.LAUNCHES name."""
    from careless_tpu_torch import kernels
    from careless_tpu_torch.ops.fused_elbo import (
        plain_fused_likelihood_grads, plain_fused_likelihood_sum,
        plain_prng_normal, pointwise_ll)
    from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk_head,
                                                  plain_trunk_head)
    from careless_tpu_torch.ops.table_gather import (plain_gather,
                                                     plain_windowed_gather)

    n = inputs.n_obs
    x = inputs.metadata
    layers, out = random_trunk(torch, gen, x.shape[1], x.shape[1], N_LAYERS,
                               dev)
    leaves = [t for layer in layers for t in (layer["w"], layer["b"])] + [
        out["w"], out["b"]]
    cts = [torch.randn(n, generator=gen, device=dev) for _ in range(2)]
    results = []
    for fn in (fused_mlp_trunk_head, plain_trunk_head):
        ys = fn(x, layers, out, 0.01)
        results.append((ys, torch.autograd.grad(ys, leaves, cts)))
    (ys_k, g_k), (ys_p, g_p) = results
    scale = max(max(y.abs().max().item() for y in ys_p), 1.0)
    held = {"trunk_fwd": max((a - b).abs().max().item()
                             for a, b in zip(ys_k, ys_p)),
            "trunk_bwd": max(((a - b).abs().max()
                              / b.abs().max().clamp_min(1e-30)).item()
                             for a, b in zip(g_k, g_p))}
    check(held["trunk_fwd"] <= 1e-4 * scale and held["trunk_bwd"] <= 1e-4,
          f"shard {label}: K1 at {n} rows differs from plain: {held}")
    del results, ys_k, ys_p, g_k, g_p
    slice_ = "laue" if inputs.is_laue else "default"
    held["gather"] = 0.0
    for name, (size, ids) in step_pairs(inputs, slice_,
                                        f"shard {label}").items():
        table = torch.randn(size, generator=gen, device=dev)
        check(torch.equal(kernels.gather(table, ids),
                          plain_gather(table, ids)),
              f"shard {label}: K2 ({name}) differs from plain")
    samples, row0, n_all = model._placement(inputs, shard)
    offsets = [s * n_all + row0 for s in samples]
    seed = 0x0FEDCBA987654321
    held["philox_normal"] = 0.0
    for off in offsets:
        e_k, bits_k = kernels.philox_normal(n, seed, off, dev, with_bits=True)
        e_p, bits_p = plain_prng_normal(n, seed, off, dev, with_bits=True)
        check(torch.equal(bits_k, bits_p), f"shard {label}: K3 words at "
              f"offset {off} differ from plain")
        held["philox_normal"] = max(held["philox_normal"],
                                    (e_k - e_p).abs().max().item())
    check(held["philox_normal"] <= 2e-5, f"shard {label}: K3 normals "
          f"differ from plain: {held['philox_normal']}")
    if model.fused_kernel:
        args = k4_inputs(torch, gen, n, dev)
        ev = torch.tensor([1.0, 0.0, 0.0], device=dev)
        ct = torch.tensor(0.75, device=dev)
        held["fused_ll_fwd"] = held["fused_ll_bwd"] = 0.0
        for off in offsets:
            cfg = dict(kind="normal", dof=0.0, t_const=0.0, seed=seed,
                       offset=off)
            eps = plain_prng_normal(n, seed, off, dev)
            got = kernels.fused_ll_fwd(*args, None, None, ev, **cfg)
            want = plain_fused_likelihood_sum(*args, None, ev, eps,
                                              kind="normal", dof=0.0)
            ipred = (args[2] * args[0] + args[2].abs() * args[1] * eps) \
                * args[3] * args[3]
            l1 = pointwise_ll("normal", 0.0, ev, args[4], args[5],
                              ipred).abs().sum().item()
            e = abs(got.item() - want.item())
            check(e <= 1e-5 * l1, f"shard {label}: K4-fwd at offset {off}: "
                  f"{got.item()} vs plain {want.item()}")
            held["fused_ll_fwd"] = max(held["fused_ll_fwd"], e)
            got = kernels.fused_ll_bwd(*args, None, None, ev, ct, **cfg)
            ref = plain_fused_likelihood_grads(*args, None, ev, eps, ct,
                                               kind="normal", dof=0.0)
            for g, r in zip(got[:4], ref[:4]):
                e = ((g - r).abs().max() / r.abs().max()).item()
                check(e <= 1e-5, f"shard {label}: K4-bwd at offset {off}: "
                      f"rel err {e}")
                held["fused_ll_bwd"] = max(held["fused_ll_bwd"], e)
    pp = getattr(getattr(inputs.plans.refl, "inner", None), "perm_plan",
                 None)
    if pp is not None and pp.stream:
        xs = torch.randn(n, generator=gen, device=dev)
        got = kernels.gather_stream(xs, pp.ids2d, pp.bases, pp.window,
                                    pp.block_rows)
        check(torch.equal(got, plain_windowed_gather(
            xs, pp.ids2d, pp.bases, pp.window, pp.block_rows)),
            f"shard {label}: K5 differs from plain")
        held["gather_stream"] = 0.0
    return held


def shard_launches(steps, laue, fused):
    """The launches of a rank's shard run of `steps` steps, one sample a
    rank: K1 once a step each way, K2 GATHERS_PER_STEP a step, K3 (unfused)
    or K4 each way (fused) once a step, K5 once a step on Laue."""
    return {**trunk_counts(steps, True, False),
            "gather": GATHERS_PER_STEP["laue" if laue else "default"] * steps,
            "philox_normal": 0 if fused else steps,
            "fused_ll_fwd": steps if fused else 0,
            "fused_ll_bwd": steps if fused else 0,
            "gather_stream": steps if laue else 0}


def shard_phase(torch, dev, seed):
    """Multi-device training (parallel/shard.py, Trainer.train's shard) on
    the one card. Each of shard_runs (the default slice's 1M observations
    on the observation axis; the same at --mc-samples=2, where K4 runs, on
    the Monte Carlo axis, one sample a rank; Laue at SHARD_LAUE_OBS rows
    with the table cap lowered so that each shard's chain permute streams
    through K5) first unsharded (shard_reference). Then NCCL at world size
    1, in this process, on the observation run: its history and
    parameters bit for bit the unsharded run's. Then two gloo ranks
    spawned on this card (distributed.spawn, shard_rank): each run's
    step-0 loss within 1e-5 relative of the unsharded run's and its
    gradients within 1e-4 (grad_rel_err), after SHARD_STEPS steps the
    merged F's correlation with the unsharded run's at least
    SHARD_MIN_CORR, the two ranks' parameters and histories bit for bit
    equal, every loss finite and each rank's launches those of
    shard_launches; each rank holds the kernels at its shapes
    (hold_shard_kernels). Then --num-devices 2 refused on this one card
    with the device-count message. Times are gloo on one card: two ranks
    share its SMs and NCCL across cards is not measured. Returns the
    kernels' largest errors by run, as shard_<run>, and rank 0's launches
    by run."""
    import tempfile
    from pathlib import Path

    import torch.distributed as dist

    import careless_tpu_torch.main as cli
    from careless_tpu_torch.parallel import distributed
    from careless_tpu_torch.parser import parser as cli_parser

    cfg = shard_config(seed)
    t_phase = time.perf_counter()
    refs = shard_reference(torch, dev, cfg)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    result = {"runs": {}}

    # NCCL at world size 1: the observation run, bit for bit the unsharded
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        distributed.initialize("nccl", "file://" + str(Path(tmp) / "store"),
                               0, 1)
        try:
            check(dist.get_backend() == "nccl", "the group is not NCCL")
            one = shard_run(torch, dev, cfg, shard_runs(cfg)[0], 0, 1)
        finally:
            dist.destroy_process_group()
    ref = refs[0]
    check(one["history"] == ref["history"] and all(
        np.array_equal(a, b) for a, b in zip(one["params"], ref["params"])),
        "shard: NCCL at world size 1 is not the unsharded run bit for bit")
    check(one["loss0"] == ref["loss0"] and all(
        torch.equal(a, b) for a, b in zip(one["grads0"], ref["grads0"])),
        "shard: NCCL world 1's step-0 gradients are not the unsharded ones")
    result["nccl_world1"] = dict(
        steps_per_s=1e3 / one["ms_per_step"],
        unsharded_steps_per_s=1e3 / ref["ms_per_step"],
        all_reduce_ms=one["all_reduce_ms"], bitwise=True)

    t0 = time.perf_counter()
    ranks = distributed.spawn(shard_rank, SHARD_WORLD, (cfg,), "gloo",
                              ["cuda:0"] * SHARD_WORLD, threads=2,
                              store_dir=str(build))
    spawn_s = time.perf_counter() - t0
    held = {}
    for i, (run, ref) in enumerate(zip(shard_runs(cfg), refs)):
        label, _, _, laue, axis = run
        mine = [r[i] for r in ranks]
        a, b = mine[0], mine[1]
        check(a["history"] == b["history"] and all(
            np.array_equal(x, y) for x, y in zip(a["params"], b["params"])),
            f"shard {label}: the two ranks' parameters differ")
        loss = np.asarray(a["history"]["loss"])
        check(len(loss) == cfg["steps"] and bool(np.all(np.isfinite(loss))),
              f"shard {label}: loss not finite over {len(loss)} steps")
        rel = abs(a["loss0"] - ref["loss0"]) / abs(ref["loss0"])
        check(rel < 1e-5, f"shard {label}: step-0 loss {a['loss0']} vs "
              f"unsharded {ref['loss0']}")
        check(a["loss0"] == b["loss0"], f"shard {label}: the ranks' step-0 "
              "losses differ")
        g_err = grad_rel_err(a["grads0"], ref["grads0"])
        check(g_err < 1e-4, f"shard {label}: step-0 gradients vs unsharded: "
              f"rel err {g_err}")
        corr = float(np.corrcoef(a["f_mean"], ref["f_mean"])[0, 1])
        check(corr >= SHARD_MIN_CORR, f"shard {label}: merged F corr with "
              f"the unsharded run {corr} < {SHARD_MIN_CORR}")
        fused = a["fused_kernel"]
        check(fused == (axis == "mc"), f"shard {label}: fused {fused}")
        for r, m in enumerate(mine):
            check_launches(m["launches"], f"shard {label} rank {r}",
                           shard_launches(cfg["steps"], laue, fused))
        held[f"shard_{label}"] = {
            k: max(m["held"].get(k, 0.0) for m in mine)
            for k in set().union(*(m["held"] for m in mine))}
        result["runs"][label] = dict(
            axis=axis, rows=[m["n_local"] for m in mine],
            row_offsets=[m["row_offset"] for m in mine],
            samples=[m["samples"] for m in mine], fused_kernel=fused,
            loss0_rel_err=rel, grad_rel_err=g_err, corr_f_unsharded=corr,
            corr_f_true=a["corr_f_true"],
            unsharded_corr_f_true=ref["corr_f_true"],
            gloo_one_card_ms_per_step=[m["ms_per_step"] for m in mine],
            unsharded_ms_per_step=ref["ms_per_step"],
            gloo_one_card_all_reduce_ms=[m["all_reduce_ms"] for m in mine],
            buffer_floats=sum(p.size for p in a["params"]) + 1,
            setup_s=[m["setup_s"] for m in mine],
            unsharded_setup_s=ref["setup_s"],
            launches_per_step={k: v / cfg["steps"]
                               for k, v in a["launches"].items() if v})

    # more devices than the card has: refused before any rank starts or
    # any file is read (an empty file stands in for the reflections)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        (Path(tmp) / "in.mtz").touch()
        args = cli_parser.parse_args(["mono", "dHKL,image_id",
                                      str(Path(tmp) / "in.mtz"),
                                      str(Path(tmp) / "out"),
                                      "--num-devices", "2"])
        try:
            cli.run_careless(args)
        except ValueError as e:
            refusal = str(e)
        else:
            refusal = None
    want = f"requested 2 devices but only {torch.cuda.device_count()} " \
        "available"
    check(refusal == want, f"shard: --num-devices 2 on one card gave "
          f"{refusal!r}, not {want!r}")
    result.update(refusal=refusal, spawn_s=spawn_s,
                  phase_s=time.perf_counter() - t_phase,
                  gloo_timing="gloo on one card: two ranks share its SMs; "
                  "not NCCL across cards")
    print("shard: " + json.dumps(result), flush=True)
    return held, {f"shard_{r['label']}": r["launches"] for r in ranks[0]}


# the stats phase: the cli phase's MTZ merged STATS_STEPS steps with
# STATS_FLAGS (the parallel half merges), then the port's statistics tools
# on its outputs; the overall pearson CC1/2 of each repeat (cchalf
# --overall -b 1) must reach STATS_MIN_CCHALF: the port on the card
# host's CPU gave 0.9405 and 0.9418 (stats_merge with --disable-gpu, seed
# 0), the card 0.9407 and 0.9417
STATS_STEPS = 100
STATS_FLAGS = ("--anomalous", "--merge-half-datasets",
               f"--half-dataset-repeats={XVAL_REPEATS}",
               "--test-fraction=0.1", "--xval-mode=parallel")
STATS_MIN_CCHALF = 0.92
STATS_BINS, STATS_ISIGI_BINS, STATS_WILSON_B = 10, 20, 20.0


def stats_merge(tmp, seed, flags=STATS_FLAGS):
    """The cli phase's MTZ (synthetic_mtz, CLI_OBS observations) written to
    tmp and merged by careless_tpu_torch.main.main(["mono", CLI_KEYS, ...,
    "--iterations=STATS_STEPS", *flags]) on the card (--disable-gpu among
    the flags: the CPU). Returns the input's path, the output base, the
    CLI's times and its argv."""
    from pathlib import Path

    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    (cols, types_), _, _ = synthetic_mtz(
        seed, CLI_OBS, CLI_IMAGES, CLI_CELL, CLI_SPACEGROUP, CLI_DMIN)
    mtz, out = str(Path(tmp) / "unmerged.mtz"), str(Path(tmp) / "merged")
    write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                      spacegroup=SpaceGroup.from_name(CLI_SPACEGROUP),
                      mtz_dtypes=types_), mtz)
    del cols
    argv = ["mono", CLI_KEYS, mtz, out, f"--iterations={STATS_STEPS}",
            "--disable-progress-bar", f"--seed={seed}", *flags]
    return mtz, out, cli_main(argv), argv


def overall_cchalf(xval_mtz, out_csv):
    """The pearson CC1/2 of each repeat over all reflections (cchalf
    --overall -b 1): {repeat: CC}."""
    from careless_tpu_torch.stats import cchalf

    result = cchalf.run_analysis(cchalf.ArgumentParser().parse_args(
        [xval_mtz, "--overall", "-b", "1", "-o", out_csv]))
    return {int(r): float(c) for r, c in zip(result["repeat"],
                                             result["CChalf"])}


def stats_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """The statistics tools and to_intensities on a merge made on the card:
    stats_merge (the cli phase's MTZ, STATS_STEPS steps with --anomalous,
    the parallel half merges and a test fraction of 0.1), then each tool of
    careless_tpu_torch/stats through its run_analysis, writing CSVs into a
    temporary directory: cchalf in each method and with --overall -b 1,
    ccanom, rsplit, ccpred, image_cc and isigi on the prediction file,
    completeness and rescale on the merged MTZ, prior_b on the input MTZ,
    filter_by_image_cc at the median image CC; then
    scripts/to_intensities --anomalous on the card and on the CPU. history
    and the plots (-i, -s) need matplotlib, which the card's machine does
    not have, so they are left out here; the CPU tests hold them.
    Checks: the merge's launches, counted from 0 just before the CLI call
    up to the half merges (cli_counts: its steps, a validation pass every
    --validation-frequency steps, two prediction passes) and from 0 just
    before the half merges to their end (half_merge_counts, one parallel
    merge of 2 x repeats halves); the main run's scaler the same after the
    half merges, bit for bit; each half's N (+ and -) summing to its rows
    (the halves DataManager.split_data_by_image draws after the test
    split, formatted here); each table has one row per file x bin (x
    repeat or x test set) and image, all holding rows at this size; every
    CC finite; the overall CC1/2 of each repeat at least
    STATS_MIN_CCHALF; ccpred has Train and Test rows; completeness has its
    overall row first and every value in [0, 1]; rescale's F ratio
    exp(-B / 4d^2) within rtol 1e-6; the filtered file keeps some rows and
    drops some; to_intensities' I on the card the CPU's bit for bit and
    SigI within rtol 1e-5. Then the merge's kernels held against their
    plain versions at its shapes (step_kernels): on the planned train rows
    (the anomalous reflection table), on the planned held-out rows of the
    validation passes, and on the stacked halves of the parallel merge
    (K1 forward only, K3 at each half's rows). Prints one `stats` line
    with each tool's seconds, the merge's set-up and steps/s. Returns the
    held kernels' errors by copy ("stats_train", "stats_test",
    "stats_xval")."""
    import importlib
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.parallel.xval import stack_halves
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.scripts import to_intensities
    from careless_tpu_torch.xtal import read_mtz

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    seconds = {}

    def tool(label, name, argv):
        mod = importlib.import_module(f"careless_tpu_torch.stats.{name}")
        t0 = time.perf_counter()
        result = mod.run_analysis(mod.ArgumentParser().parse_args(argv))
        seconds[label] = time.perf_counter() - t0
        return result

    seen = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        with counted_half_merges(torch, seen):
            torch.cuda.synchronize()
            kernels.reset_launches()
            mtz, out, times, argv = stats_merge(tmp, seed)
            torch.cuda.synchronize()
        xval, preds = out + "_xval_0.mtz", out + "_predictions_0.mtz"
        merged = out + "_0.mtz"

        def csv(label):
            return ["-o", str(Path(tmp) / f"{label}.csv")]

        R, B = XVAL_REPEATS, STATS_BINS
        tables = {}
        for method in ("pearson", "spearman", "weighted"):
            tables[f"cchalf_{method}"] = tool(
                f"cchalf_{method}", "cchalf",
                [xval, "-m", method] + csv(f"cchalf_{method}"))
        t0 = time.perf_counter()
        cc_half = overall_cchalf(xval, str(Path(tmp) / "overall.csv"))
        seconds["cchalf_overall"] = time.perf_counter() - t0
        tables["ccanom"] = tool("ccanom", "ccanom", [xval] + csv("ccanom"))
        tables["rsplit"] = tool("rsplit", "rsplit", [xval] + csv("rsplit"))
        tables["ccpred"] = tool("ccpred", "ccpred", [preds] + csv("ccpred"))
        images = tool("image_cc", "image_cc", [preds] + csv("image_cc"))
        isigi = tool("isigi", "isigi", [preds] + csv("isigi"))
        complete = tool("completeness", "completeness",
                        [merged] + csv("completeness"))
        rescaled = tool("rescale", "rescale",
                        [merged, str(Path(tmp) / "rescaled.mtz"), "-b",
                         str(STATS_WILSON_B)])
        fit = tool("prior_b", "prior_b", [mtz])
        cutoff = float(np.nanmedian(images["CCpred"]))
        filtered = tool("filter_by_image_cc", "filter_by_image_cc",
                        [mtz, preds, "-c", str(cutoff), "-o",
                         str(Path(tmp) / "filtered")])
        kept = len(read_mtz(filtered[0]))

        args = to_intensities.ArgumentParser().parse_args(
            ["--anomalous", merged, str(Path(tmp) / "intensities.mtz")])
        t0 = time.perf_counter()
        on_card = to_intensities.run(args)
        seconds["to_intensities"] = time.perf_counter() - t0
        on_cpu = to_intensities.run(args, device="cpu")
        source = read_mtz(merged)
        halved = read_mtz(xval)

        # the rows main() trained on, validated on and split into halves
        args = cli_parser.parse_args(argv)
        inputs, rac = MonoFormatter.from_parser(args).format_files(
            [mtz], device=dev)
        dm = DataManager(inputs, rac, parser=args, device=dev)
        del inputs
        train, test = dm.split_data_by_refl(args.test_fraction)
        halves = [h for _ in range(XVAL_REPEATS)
                  for h in dm.split_data_by_image()]
        half_rows = [h.n_obs for h in halves]
        held = {}
        for label, rows_ in (("train", train), ("test", test)):
            planned = dm.planned_inputs(rows_).inputs
            held[f"stats_{label}"], _ = step_kernels(
                torch, dev, gen, planned, "default", peak_flops, peak_bw,
                f"stats {label}")
            del planned
        stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                               dm.n_refl, dm.n_images)
        held["stats_xval"] = step_kernels(
            torch, dev, gen, stacked.inputs, "xval", peak_flops, peak_bw,
            "stats xval parallel", frozen_scaler=True,
            noise_calls=half_rows)[0]
        n_train, n_test = train.n_obs, test.n_obs
        del stacked, halves, train, test, dm

    K = 2 * XVAL_REPEATS
    check_launches(seen["main"], "stats main run", cli_counts(
        STATS_STEPS, passes=-(-STATS_STEPS // args.validation_frequency),
        predictions=2))
    check_launches(seen["xval"], "stats half merges",
                   half_merge_counts(STATS_STEPS, K, 1))
    check(seen["scaler_kept"], "stats: the half merges changed the main "
          "run's scaler")
    tags = sorted(set(zip(halved["repeat"].tolist(),
                          halved["half"].tolist())))
    n = [float(sum(np.nansum(halved[c][(halved["repeat"] == r)
                                       & (halved["half"] == h)]
                             .astype(np.float64)) for c in ("N(+)", "N(-)")))
         for r, h in tags]
    check(len(tags) == K and n == half_rows, f"stats: N sums to {n} by "
          f"half, the halves hold {half_rows} rows")
    for label, t in tables.items():
        keys = sorted(zip(t["bin"].tolist(), (t["test"] if "test" in t
                                              else t["repeat"]).tolist()))
        want = ([(b, s) for b in range(B) for s in ("Test", "Train")]
                if "test" in t else [(b, r) for b in range(B)
                                     for r in range(R)])
        files = {preds if "test" in t else xval}
        check(keys == want and set(t["file"].tolist()) == files,
              f"stats: {label} rows {keys[:4]}... for {len(want)} groups")
        value = t.columns[-1]
        check(bool(np.isfinite(t[value]).all()),
              f"stats: {label} has non-finite values: {t[value]}")
    check(sorted(cc_half) == list(range(R)) and all(
        math.isfinite(c) and c >= STATS_MIN_CCHALF for c in cc_half.values()),
        f"stats: overall CC1/2 {cc_half}, expected at least "
        f"{STATS_MIN_CCHALF}")
    check(set(tables["ccpred"]["test"].tolist()) == {"Train", "Test"},
          "stats: ccpred lacks Train or Test rows")
    check(len(images) == CLI_IMAGES and bool(
        np.isfinite(images["CCpred"]).all()) and np.array_equal(
        images["BATCH"], np.arange(1, CLI_IMAGES + 1)),
        f"stats: image_cc gave {len(images)} rows for {CLI_IMAGES} images")
    check(len(isigi) == STATS_ISIGI_BINS
          and bool(np.isfinite(isigi["I/sigI"]).all()),
          f"stats: isigi gave {len(isigi)} rows")
    values = np.concatenate([complete[c] for c in ("all", "anomalous")])
    check(complete["Resolution Range (Å)"][0] == "overall"
          and len(complete) == B + 1
          and bool(np.all((values >= 0) & (values <= 1))),
          f"stats: completeness {complete['all']}")
    d = source.cell.compute_d(source.get_hkls()).astype(np.float32)
    ratio = rescaled["F(+)"].astype(np.float64) / source["F(+)"]
    ok = np.isfinite(ratio)
    check(bool(np.allclose(ratio[ok], np.exp(
        -STATS_WILSON_B / (4 * d[ok].astype(np.float64) ** 2)),
        rtol=1e-6, atol=0)), "stats: rescale's F ratio is not "
        "exp(-B / 4d^2)")
    check(0 < kept < CLI_OBS, f"stats: filter_by_image_cc kept {kept} of "
          f"{CLI_OBS} rows at cut-off {cutoff}")
    check(math.isfinite(fit.slope), f"stats: prior_b's fit {fit}")
    check(on_card.columns == on_cpu.columns, "stats: to_intensities' "
          "columns differ between the card and the CPU")
    sig_err = 0.0
    for c in on_card.columns:
        a, b = on_card[c], on_cpu[c]
        same_nan = np.array_equal(np.isnan(a), np.isnan(b))
        if c.startswith("SigI"):
            ok = ~np.isnan(b)
            rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-30)
            sig_err = max(sig_err, float(rel.max()))
            check(same_nan and bool(np.allclose(a[ok], b[ok], rtol=1e-5,
                                                atol=0)),
                  f"stats: to_intensities {c} on the card differs from the "
                  f"CPU's by {rel.max()} relative")
        else:
            check(same_nan and np.array_equal(a[~np.isnan(a)],
                                              b[~np.isnan(b)]),
                  f"stats: to_intensities {c} differs between the card and "
                  "the CPU")
    out = dict(
        observations=CLI_OBS, steps=STATS_STEPS,
        setup_s=times["setup_s"], steps_per_s=times["steps"]
        / times["train_s"], xval_setup_s=times["xval_setup_s"],
        xval_steps_per_s=STATS_STEPS / times["xval_train_s"],
        cchalf_overall=cc_half, min_cchalf=STATS_MIN_CCHALF,
        wilson_b=-2.0 * fit.slope, image_cc_cutoff=cutoff,
        filtered_rows=kept, to_intensities_sigi_max_rel_diff=sig_err,
        train_rows=n_train, held_out_rows=n_test, half_rows=half_rows,
        launches={k: {n: v for n, v in seen[k].items() if v}
                  for k in ("main", "xval")},
        held_max_abs_err=held, tool_s=seconds)
    print("stats: " + json.dumps(out), flush=True)
    return held


# the double-Wilson CLI: a parent MTZ of PRIOR_OBS observations and a
# sparser, noisier child (PRIOR_CHILD_OBS, SIGI = 0.05 + PRIOR_CHILD_SIGMA I)
# whose true F is drawn at correlation PRIOR_R from the parent's, merged
# PRIOR_STEPS steps: the case the prior is for, where the parent informs
# the child's reflections beyond its own few observations
PRIOR_OBS, PRIOR_IMAGES, PRIOR_STEPS, PRIOR_DMIN, PRIOR_R = \
    200_000, 500, 1_000, 2.0, 0.9
PRIOR_CHILD_OBS, PRIOR_CHILD_SIGMA = 20_000, 0.5
# the parent's merged F's least correlation with its true F, and the least
# the coupled child's correlation must exceed the child's merged alone
# under the Wilson prior by: the first card reading (seed 0) gave 0.9639,
# and 0.7763 against 0.2123, a gain of 0.5640; a prior blind to the parent
# is the Wilson prior, and gains ~0
PRIOR_MIN_CC, PRIOR_MIN_GAIN = 0.94, 0.45


def child_f(seed, f_parent, r):
    """A child's true amplitudes |r F + sqrt(1 - r^2) e|, F the parent's
    (its phase taken as 0) and e a complex normal of unit mean square: the
    double-Wilson model's child, Wilson-distributed again."""
    rng = np.random.default_rng(seed)
    e = (rng.normal(size=len(f_parent))
         + 1j * rng.normal(size=len(f_parent))) / np.sqrt(2.0)
    return np.abs(r * f_parent + np.sqrt(1.0 - r * r) * e)


def prior_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """The double-Wilson prior through the port's CLI, on the card: two
    seeded MTZs of one truth (synthetic_mtz in the cli cell's P 21 21 21 to
    PRIOR_DMIN: the parent at PRIOR_OBS observations; the child at
    PRIOR_CHILD_OBS with PRIOR_CHILD_SIGMA's errors and its true F from
    child_f at r = PRIOR_R), merged by careless_tpu_torch.main.main(
    ["mono", CLI_KEYS, parent, child, out, "--separate-files",
    "--double-wilson-parents=None,0", "--double-wilson-r=0.,0.9",
    "--optimize-double-wilson-r"]) for PRIOR_STEPS steps in this process;
    then the child alone under the Wilson prior, the same steps. Checks:
    the history's rDW_0 and rDW_1 columns, rDW_1 finite and inside (-1, 1);
    the loss finite and falling; the parent's merged F correlating with its
    true F at least PRIOR_MIN_CC, and the coupled child's above the child's
    merged alone by at least PRIOR_MIN_GAIN (a prior blind to its parent is
    the Wilson prior, and gains nothing); the launches, counted from 0 just
    before the coupled call: the cli phase's at these steps. Then the
    kernels of the path, held against their plain versions at its shapes
    (step_kernels on the planned inputs that the same formatter and data
    manager calls give: both files' rows in one two-ASU table). Prints the
    correlations, r's path and the set-up, steps/s and output times.
    Returns each held kernel's largest error."""
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         read_mtz, write_mtz)

    parent = synthetic_mtz(seed + 10, PRIOR_OBS, PRIOR_IMAGES, CLI_CELL,
                           CLI_SPACEGROUP, PRIOR_DMIN)
    child = synthetic_mtz(seed + 11, PRIOR_CHILD_OBS, PRIOR_IMAGES, CLI_CELL,
                          CLI_SPACEGROUP, PRIOR_DMIN,
                          f_true=child_f(seed + 12, parent[2], PRIOR_R),
                          rel_sigma=PRIOR_CHILD_SIGMA)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        files = []
        for name, ((cols, types_), _, _) in (("parent", parent),
                                            ("child", child)):
            files.append(str(Path(tmp) / f"{name}.mtz"))
            write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                              spacegroup=SpaceGroup.from_name(
                                  CLI_SPACEGROUP), mtz_dtypes=types_),
                      files[-1])
        out = str(Path(tmp) / "dw")
        argv = ["mono", CLI_KEYS, *files, out, f"--iterations={PRIOR_STEPS}",
                "--disable-progress-bar", f"--seed={seed}",
                "--separate-files", "--double-wilson-parents=None,0",
                "--double-wilson-r=0.,0.9", "--optimize-double-wilson-r"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = cli_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        merged = [read_mtz(f"{out}_{i}.mtz") for i in range(2)]
        with open(out + "_history.csv") as f:
            lines = f.read().splitlines()
        alone = str(Path(tmp) / "child_alone")
        torch.cuda.reset_peak_memory_stats()
        alone_times = cli_main(["mono", CLI_KEYS, files[1], alone,
                                f"--iterations={PRIOR_STEPS}",
                                "--disable-progress-bar", f"--seed={seed}"])
        torch.cuda.synchronize()
        alone_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        alone = read_mtz(alone + "_0.mtz")

        # the kernels at this path's shapes, on the inputs main() trains on
        args = cli_parser.parse_args(argv)
        inputs, rac = MonoFormatter.from_parser(args).format_files(
            files, device=dev)
        planned = DataManager(inputs, rac, parser=args,
                              device=dev).planned_inputs().inputs
        del inputs
        held, _ = step_kernels(torch, dev, gen, planned, "default",
                               peak_flops, peak_bw, "prior")
        del planned
    head = lines[0].split(",")
    history = {k: [float(r.split(",")[j]) for r in lines[1:]]
               for j, k in enumerate(head)}
    loss, r1 = history["loss"], history.get("rDW_1", [])
    check("rDW_0" in history and len(r1) == PRIOR_STEPS
          and all(math.isfinite(v) and -1 < v < 1 for v in r1),
          f"prior: rDW_1 not finite inside (-1, 1): {r1[:2]} ... {r1[-2:]}")
    check(len(loss) == PRIOR_STEPS and all(map(math.isfinite, loss))
          and loss[-1] < loss[0], f"prior: loss not finite and falling: "
          f"{loss[:2]} ... {loss[-2:]}")
    cc_parent, cc_child = (
        cc_true_f(f"prior {name}", m, truth[1], truth[2])
        for name, m, truth in (("parent", merged[0], parent),
                               ("child", merged[1], child)))
    cc_alone = cc_true_f("prior child alone", alone, child[1], child[2])
    check(cc_parent >= PRIOR_MIN_CC, f"prior: the parent's merged F "
          f"correlates {cc_parent:.4f} with its true F, expected at least "
          f"{PRIOR_MIN_CC}")
    check(cc_child >= cc_alone + PRIOR_MIN_GAIN, f"prior: the coupled "
          f"child's merged F correlates {cc_child:.4f} with its true F, the "
          f"child's alone {cc_alone:.4f}: expected a gain of at least "
          f"{PRIOR_MIN_GAIN}")
    check_launches(launches, "prior", {
        **{k: (PRIOR_STEPS + 2 if k == "trunk_fwd" else v)
           for k, v in trunk_counts(PRIOR_STEPS, True, False).items()},
        "gather": GATHERS_PER_STEP["default"] * PRIOR_STEPS + 2,
        "philox_normal": PRIOR_STEPS, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
        "gather_stream": 0})
    result = dict(cc_true_f_parent_child=[cc_parent, cc_child],
                  cc_true_f_child_alone_wilson=cc_alone,
                  child_gain=cc_child - cc_alone,
                  true_f_correlation=float(np.corrcoef(parent[2],
                                                       child[2])[0, 1]),
                  rDW_1_first_last=[r1[0], r1[-1]],
                  loss_first_last=[loss[0], loss[-1]],
                  reflections=[len(m) for m in merged],
                  launches={k: v for k, v in launches.items() if v},
                  held_max_abs_err=held)
    print("prior: " + json.dumps(result), flush=True)
    print_cli_times("prior", times, peak_gb)
    print_cli_times("prior child alone", alone_times, alone_peak_gb)
    return held


# the library phase: a ReferencePrior (kind normal) on this share of the
# reflections, its loc the true F times (1 + LIBRARY_REF_NOISE N(0, 1))
# and its scale LIBRARY_REF_SCALE; NeuralNormalLikelihood of
# LIBRARY_NEURAL (layers, width), the JAX test's size
LIBRARY_REF_FRACTION, LIBRARY_REF_NOISE, LIBRARY_REF_SCALE = 0.6, 0.1, 0.1
LIBRARY_NEURAL = (3, 6)
# the posterior mean's least CC with the true F after STEPS steps: the
# prediction made before the first card run, from the port on the CPU at
# this phase's sizes (tools/library_cc.py --cpu: 0.6403), less 0.05
LIBRARY_MIN_CC = 0.59


def library_parts(model, params, trainer, f_true, seed):
    """The library-level model parts on a model built by model_on, on its
    device: RiceWoolfsonPosterior (from the same Wilson moments as the
    truncated normal, so params["posterior"] stays), a ReferencePrior of
    kind normal on a seeded LIBRARY_REF_FRACTION of the reflections (the
    unobserved ones' loc and scale filled with 1, finite), and
    NeuralNormalLikelihood(*LIBRARY_NEURAL) with its weights drawn from a
    CPU generator seeded with seed + 21 (the same on every device).
    Returns (model, params, trainer)."""
    import dataclasses

    import torch

    from careless_tpu_torch.models.likelihoods.mono import \
        NeuralNormalLikelihood
    from careless_tpu_torch.models.merging.surrogate import \
        RiceWoolfsonPosterior
    from careless_tpu_torch.models.merging.variational import map_params
    from careless_tpu_torch.models.priors.empirical import ReferencePrior

    dev = model.prior.centric.device
    rng = np.random.default_rng(seed + 20)
    n_refl = len(f_true)
    observed = rng.random(n_refl) < LIBRARY_REF_FRACTION
    loc = np.abs(f_true * (1.0 + LIBRARY_REF_NOISE * rng.normal(
        size=n_refl))).astype(np.float32)
    scale = np.full(n_refl, LIBRARY_REF_SCALE, np.float32)
    loc[~observed], scale[~observed] = 1.0, 1.0
    likelihood = NeuralNormalLikelihood(*LIBRARY_NEURAL)
    gen = torch.Generator().manual_seed(seed + 21)
    params = dict(params, likelihood=map_params(
        lambda t: t.to(dev), likelihood.init("cpu", gen)))
    model = dataclasses.replace(
        model, posterior=RiceWoolfsonPosterior(centric=model.prior.centric),
        prior=ReferencePrior(*(torch.as_tensor(a, device=dev)
                               for a in (observed, loc, scale))),
        likelihood=likelihood)
    return model, params, dataclasses.replace(trainer, model=model)


def library_phase(torch, dev, gen, seed, peak_flops, peak_bw):
    """The library-level parts on the card at the default slice's full
    width (N_OBS observations, N_REFL reflections, N_IMAGES images,
    D_META metadata columns, the N_LAYERS-layer HybridImageScaler of
    width D_META): RiceWoolfsonPosterior, a normal ReferencePrior and
    NeuralNormalLikelihood (library_parts), STEPS full-batch Adam steps
    (train_slice: the loss finite and falling, steps/s, device time and
    busy share). Gates: K1-fwd and K1-bwd once a step, K2
    GATHERS_PER_STEP["library"] a step, K3 once a step, no K4 (the
    likelihood has no fused kind) and no K5; the posterior mean's CC with
    the true F at least LIBRARY_MIN_CC; then K1, K2 and K3 held against
    their plain versions at this phase's shapes (step_kernels). Returns
    (launches, each held kernel's largest error)."""
    t0 = time.perf_counter()
    times = {}
    model, params, trainer, inputs, f_true = model_on(
        None, seed, N_OBS, N_REFL, N_IMAGES, D_META, N_LAYERS, times=times)
    model, params, trainer = library_parts(model, params, trainer, f_true,
                                           seed)
    torch.cuda.synchronize()
    launches, _, _, _, out = train_slice(
        torch, dev, seed, model, params, trainer, inputs, f_true, STEPS,
        CHUNK, "library", {"library": "RiceWoolfsonPosterior, "
                           "ReferencePrior(normal), NeuralNormalLikelihood"
                           f"{LIBRARY_NEURAL}"},
        time.perf_counter() - t0, times)
    check(not model.fused_kernel and not model._fused_eligible(inputs),
          "library: the model took K4")
    check_launches(launches, "library", {
        **trunk_counts(STEPS, True, False),
        "gather": GATHERS_PER_STEP["library"] * STEPS,
        "philox_normal": STEPS, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
        "gather_stream": 0})
    cc = out["posterior_mean_corr_f_true"]
    check(cc >= LIBRARY_MIN_CC,
          f"library: the posterior mean correlates {cc:.4f} with the true "
          f"F, expected at least {LIBRARY_MIN_CC}")
    held, _ = step_kernels(torch, dev, gen, inputs, "library", peak_flops,
                           peak_bw, "library")
    for key in ("steps_per_s", "ms_per_step", "device_ms_per_step",
                "busy_share", "posterior_mean_corr_f_true", "peak_mem_gb"):
        print(f"library {key}: {out[key]}", flush=True)
    return launches, held


FLAGS_STEPS = 20


def flags_phase(torch, dev, seed):
    """--save-data-manager and --profile-dir through the port's CLI, on the
    card, after every host-time measurement (a profiler session slows
    later PyTorch calls): the cli phase's MTZ merged FLAGS_STEPS steps by
    main(["mono", ..., "--save-data-manager", "--profile-dir=DIR"]).
    Gates: <out>_data_manager.pickle loads with DataManager.from_pickle on
    the card and on the CPU, its Inputs bit for bit the formatter's on
    the same file; DIR holds one trace that parses as JSON and names every
    port kernel the run launched (kernels.PROFILED_KERNELS) at least once
    (the card's profiler drops some records, so no count is gated). Prints
    the pickle's and the trace's sizes, the trace's events and the run's
    times."""
    import glob
    import os
    import tempfile
    from pathlib import Path

    from careless_tpu_torch import kernels
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.models.base import ROW_FIELDS
    from careless_tpu_torch.parser import parser as cli_parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    (cols, types_), _, _ = synthetic_mtz(
        seed, CLI_OBS, CLI_IMAGES, CLI_CELL, CLI_SPACEGROUP, CLI_DMIN)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mtz, out = str(Path(tmp) / "unmerged.mtz"), str(Path(tmp) / "flags")
        trace_dir = str(Path(tmp) / "trace")
        write_mtz(DataSet(cols, cell=UnitCell(*CLI_CELL),
                          spacegroup=SpaceGroup.from_name(CLI_SPACEGROUP),
                          mtz_dtypes=types_), mtz)
        argv = ["mono", CLI_KEYS, mtz, out, f"--iterations={FLAGS_STEPS}",
                "--disable-progress-bar", f"--seed={seed}",
                "--save-data-manager", f"--profile-dir={trace_dir}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = cli_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        pickle_path = out + "_data_manager.pickle"
        pickle_mb = os.path.getsize(pickle_path) / 1e6
        t0 = time.perf_counter()
        on_cpu = DataManager.from_pickle(pickle_path, "cpu")
        load_s = time.perf_counter() - t0
        on_card = DataManager.from_pickle(pickle_path)
        args = cli_parser.parse_args(argv)
        inputs, _ = MonoFormatter.from_parser(args).format_files(
            [mtz], device="cpu")
        for name, dm in (("the CPU", on_cpu), ("the card", on_card)):
            check(dm.device.type == ("cpu" if name == "the CPU" else "cuda"),
                  f"flags: the pickle loaded on {dm.device}, not {name}")
            for f in ROW_FIELDS:
                a, b = getattr(dm.inputs, f), getattr(inputs, f)
                check((a is None and b is None) or (
                    a is not None and b is not None
                    and torch.equal(a.cpu(), b)),
                    f"flags: the pickle's {f} on {name} is not the run's")
        del on_cpu, on_card, inputs
        traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        check(len(traces) == 1, f"flags: {len(traces)} traces in "
              f"{trace_dir}, expected one")
        trace_mb = os.path.getsize(traces[0]) / 1e6
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    named = {}
    for symbols, kernel_names in kernels.PROFILED_KERNELS:
        if not sum(launches[k] for k in kernel_names):
            continue
        named[symbols[0]] = sum(1 for n in names
                                if any(sym in n for sym in symbols))
    missing = [k for k, v in named.items() if not v]
    check(not missing, f"flags: the trace names no {missing}")
    result = dict(steps=FLAGS_STEPS, pickle_mb=pickle_mb,
                  pickle_load_cpu_s=load_s, trace_mb=trace_mb,
                  trace_events=len(events),
                  trace_mb_per_step=trace_mb / FLAGS_STEPS,
                  kernels_named=sorted(named),
                  launches={k: v for k, v in launches.items() if v})
    print("flags: " + json.dumps(result), flush=True)
    print(f"flags pickle MB: {pickle_mb}; trace MB: {trace_mb}",
          flush=True)
    print_cli_times("flags (profiled)", times, peak_gb)
    return result


def trunk_counts(steps, head, bf16, wide=False):
    """The K1 launch counts of a slice that runs the (head, bf16)
    instantiation (of csrc/trunk_wide.cu when wide) once per step in each
    direction and no other."""
    from careless_tpu_torch import kernels
    mine = {kernels.trunk_key(d, head, bf16, wide) for d in ("fwd", "bwd")}
    return {k: steps if k in mine else 0 for k in kernels.LAUNCHES
            if k.startswith("trunk")}


def check_launches(launches, label, want):
    """Each kernel of the slice launched as often as its path says
    (`want`: name -> count, or None for "at least once")."""
    for name, count in want.items():
        ok = launches[name] > 0 if count is None else launches[name] == count
        check(ok, f"slice {label}: kernel {name} launched {launches[name]} "
              f"times, expected {count if count is not None else '> 0'}")


def cli_counts(steps, passes=0, predictions=1):
    """The launches of a mono CLI run of the default model: its steps',
    plus a K1-fwd, two K2 and a K3 for each validation pass, plus two
    K1-fwd and two K2 for each prediction pass (two with a test fraction:
    the train rows and the held-out rows)."""
    return {**{k: (steps + passes + 2 * predictions if k == "trunk_fwd"
                   else v) for k, v in trunk_counts(steps, True,
                                                    False).items()},
            "gather": GATHERS_PER_STEP["default"] * steps + 2 * passes
            + 2 * predictions,
            "philox_normal": steps + passes, "fused_ll_fwd": 0,
            "fused_ll_bwd": 0, "gather_stream": 0}


def half_merge_counts(steps, halves, merges):
    """The launches of the CLI's half merges of `halves` halves in `merges`
    merges (halves serial, 1 parallel): per merge and step a K1-fwd and
    GATHERS_PER_STEP["xval"] K2, per half and step a K3; never K1-bwd (the
    scaler is frozen), K4 or K5."""
    from careless_tpu_torch import kernels
    return {**{k: 0 for k in kernels.LAUNCHES if k.startswith("trunk")},
            "trunk_fwd": merges * steps,
            "gather": GATHERS_PER_STEP["xval"] * merges * steps,
            "philox_normal": halves * steps, "fused_ll_fwd": 0,
            "fused_ll_bwd": 0, "gather_stream": 0}


def window_device_times(events, launched, steps):
    """(rows of (ms per step, launches per step, kernel), launches each
    kernel's records stand for, whether every port kernel that launched
    left a record) of a profiled window of `steps` steps: `events` are
    key_averages() entries (key, count, self_device_time_total in us),
    `launched` the window's kernels.LAUNCHES. A kernel's time is its mean
    over the records kept times the launches they stand for: a port
    kernel's launches (kernels.PROFILED_KERNELS), any other kernel's
    records rounded to a whole number per step (whole_launches), never
    fewer than it left."""
    from careless_tpu_torch import kernels

    stands_for, complete = {}, True
    for symbols, names in kernels.PROFILED_KERNELS:
        mine = [e for e in events if any(s in e.key for s in symbols)]
        want = sum(launched[k] for k in names)
        kept = sum(e.count for e in mine)
        complete &= kept > 0 or want == 0
        for e in mine:
            stands_for[e.key] = e.count * want / kept
    for e in events:
        if e.key not in stands_for:
            stands_for[e.key] = max(e.count, whole_launches(e.count, steps))
    rows = sorted(((e.self_device_time_total / e.count * stands_for[e.key]
                    / 1e3 / steps, stands_for[e.key] / steps, e.key)
                   for e in events if stands_for[e.key]), reverse=True)
    return rows, stands_for, complete


def profile_steps(torch, trainer, params, inputs, seed, ms_per_step,
                  steps=20):
    """Device time per step by kernel (torch.profiler, CUPTI) over a short
    window; the busy share is that device time over the unprofiled step
    time measured above (one stream, so kernels do not overlap); returns
    what it prints. The profiler drops some kernel records of a window
    (_device_times), so each kernel's time stands for the launches that
    window_device_times counts; a window in which a port kernel launched
    and left no record gives no device time (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from careless_tpu_torch import kernels
    from careless_tpu_torch.device import seeded_generator

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train(params, seeded_generator(seed + 1, inputs.device),
                      inputs, steps, chunk_size=steps)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies); host ranges and their
    # device-side annotations would count the same time twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total
              and not getattr(e, "is_user_annotation", False)]
    rows, stands_for, complete = window_device_times(
        events, dict(kernels.LAUNCHES), steps)
    for e in events:
        CAPTURED["records"] += e.count
        CAPTURED["launches"] += stands_for[e.key]
    device_ms = sum(r[0] for r in rows) if complete else None
    out = dict(device_ms_per_step=device_ms,
               busy_share=device_ms / ms_per_step if device_ms else None,
               records_kept=sum(e.count for e in events),
               launches_stood_for=sum(stands_for.values()),
               top=[dict(ms_per_step=ms, calls_per_step=c, name=k[:80])
                    for ms, c, k in rows[:15]])
    print("profile: " + json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from careless_tpu_torch.kernels._build import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; peaks used {peak_flops / 1e12:g} TFLOP/s "
          f"f32, {peak_bw / 1e12:g} TB/s", flush=True)
    t0 = time.perf_counter()
    library()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = kernel_phase(torch, dev, gen, peak_flops, peak_bw)
    swap_case(torch, dev, gen, peak_flops, peak_bw)
    wide_trunk_phase(torch, gen, dev, peak_flops, peak_bw)
    check_phase(torch, dev, args.seed)
    for label, flags in {**SCALER_SLICES, "wide": WIDE_SLICE,
                         "wide_bf16": dict(WIDE_SLICE,
                                           mlp_dtype="bfloat16"),
                         "analytic_kl": dict(analytic_kl=True)}.items():
        check_phase(torch, dev, args.seed, flags, label)
    check_phase(torch, dev, args.seed, DOUBLE_WILSON, "double_wilson",
                two_files=True)
    check_phase(torch, dev, args.seed, label="library", library=True)
    check_mc2_phase(torch, dev, args.seed)
    check_laue_phase(torch, dev, args.seed)

    launches, _, _, _, _ = slice_phase(torch, dev, args.seed, STEPS, CHUNK)
    check_launches(launches, "default", {
        **trunk_counts(STEPS, True, False),
        "gather": GATHERS_PER_STEP["default"] * STEPS, "philox_normal": None,
        "fused_ll_fwd": 0, "fused_ll_bwd": 0, "gather_stream": 0})

    launches_a, model, _, _, _ = slice_phase(torch, dev, args.seed, STEPS,
                                             CHUNK, "a", SLICE_A)
    check(model.fused_kernel, "slice (a): --fused-kernel=auto did not "
          "select K4 at mc = 2 and 1M observations")
    check_launches(launches_a, "a", {
        **trunk_counts(STEPS, True, False),
        "gather": GATHERS_PER_STEP["a"] * STEPS,
        "philox_normal": 0, "fused_ll_fwd": 2 * STEPS,
        "fused_ll_bwd": 2 * STEPS, "gather_stream": 0})

    launches_b, model, start, trained, _ = slice_phase(
        torch, dev, args.seed, STEPS_B, CHUNK, "b", SLICE_B)
    check(model.fused_kernel, "slice (b) did not select K4")
    check_launches(launches_b, "b", {
        **trunk_counts(STEPS_B, True, False),
        "gather": GATHERS_PER_STEP["b"] * STEPS_B,
        "philox_normal": 0, "fused_ll_fwd": 2 * STEPS_B,
        "fused_ll_bwd": 2 * STEPS_B, "gather_stream": 0})
    ev11 = {k: (start["likelihood"][k].item(), v.item())
            for k, v in trained["likelihood"].items()}
    check(all(math.isfinite(b) and b != a for a, b in ev11.values()),
          f"slice (b): the Ev11 parameters did not move finitely: {ev11}")
    print("slice b Ev11 raw parameters (start, trained): " + json.dumps(ev11),
          flush=True)

    scaler_launches = scaler_slices_phase(torch, dev, args.seed)
    wide_launches = wide_slice_phase(torch, dev, args.seed)
    cli_phase(torch, dev, args.seed)
    held_at = resume_phase(torch, dev, gen, args.seed, peak_flops, peak_bw)
    held_at.update(xval_phase(torch, dev, gen, args.seed, peak_flops,
                              peak_bw))
    shard_held, shard_counts = shard_phase(torch, dev, args.seed)
    held_at.update(shard_held)
    held_at.update(stats_phase(torch, dev, gen, args.seed, peak_flops,
                               peak_bw))
    held_at["prior"] = prior_phase(torch, dev, gen, args.seed, peak_flops,
                                   peak_bw)
    library_launches, held_at["library"] = library_phase(
        torch, dev, gen, args.seed, peak_flops, peak_bw)
    held_at.update({label: phase(torch, dev, gen, args.seed, peak_flops,
                                 peak_bw)[1]
                    for label, phase in (("poly_cli", poly_cli_phase),
                                         ("stream_cli", stream_cli_phase),
                                         ("stills", stills_phase))})

    rows["gather_stream"], launches_laue, held_at["laue"], \
        rows[LAUE_PERM_ROW] = laue_phase(torch, dev, gen, args.seed,
                                         peak_flops, peak_bw)
    for label, held in held_at.items():
        for k, err in held.items():
            rows[k][f"{label}_max_abs_err"] = err
            if label in shard_counts:
                rows[k][f"{label}_launches"] = shard_counts[label][k]
    again = launch_phase(torch, dev, gen, steps=False)
    rows["gather"]["launch_path_host_us_after_profiling"] = again
    for kname, key in K4_HOST.items():
        rows[kname]["host_us_after_profiling"] = again[key]
    print("profiler: kernel records captured of the launches device_ms "
          "timed: " + json.dumps(CAPTURED), flush=True)
    flags_phase(torch, dev, args.seed)
    for k, v in {**trunk_counts(STEPS, True, False), "gather": 1,
                 "philox_normal": 1}.items():
        if v:
            rows[k]["library_launches"] = library_launches[k]

    # launches: K1-K3 from the default slice, the other K1 instantiations
    # from the scaler slices, K4 from slice (a), K5 and K2's Laue row from
    # the Laue slice
    counts = {**launches, **scaler_launches, **wide_launches,
              "fused_ll_fwd": launches_a["fused_ll_fwd"],
              "fused_ll_bwd": launches_a["fused_ll_bwd"],
              "gather_stream": launches_laue["gather_stream"],
              LAUE_PERM_ROW: launches_laue["gather"]}
    kernel_of = {LAUE_PERM_ROW: "gather"}
    table = [dict(name=k, route="cuda",
                  source=("careless_tpu_torch/" + v["kernel"] if "kernel" in v
                          else SOURCES[kernel_of.get(k, k)]),
                  replaces=REPLACES[kernel_of.get(k, k)], launches=counts[k],
                  **v)
             for k, v in rows.items()]
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
