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
     noise, and its in-kernel normals bitwise against K3's, its Student-t
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
     layers of width 32, its forward bit for bit csrc/trunk.cu's at a
     shape both take, its dW bitwise repeatable, and its head f32 pair at
     the `wide` slice's 1M shape; the K1, K3 and K4 launchers' host time per
     call, measured before any profiler capture, sits in their rows
     (host_us; K3's beside torch.randn's, with randn's device time; K3 is
     also held at an offset that is not a multiple of 4);
  3. check: the port's loss and every parameter gradient at a small size on
     the card against the same computation on the CPU (plain versions), at
     mc = 1 for the defaults, --image-layers 2, --mlp-dtype bfloat16,
     both, --mlp-width 128 and --mlp-width 128 --mlp-dtype bfloat16, and
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
     busy share and peak memory on lines of their own. Every loss finite,
     the loss falling, and each kernel of the slice launched by that run
     (the counts are set to 0 just before it), each slice's own K1
     instantiation once per step and every other not at all, K2 as often
     as GATHERS_PER_STEP says;
  5. the Laue slice (`careless-tpu poly` defaults) at 10,000,000
     observations, 500,000 reflections and 20,000 images on the harmonic-
     chain layout: the host set-up timed step by step, every kernel of the
     step held against its plain version and timed at the step's shapes
     (K1 on the 10M metadata, K2 at each of its nine table and id pairs, K3
     at 10M, K5 at the chain plan's own backward permute; K2 at the image
     cotangent's random 10M permute is a row of the kernels line of its
     own), then 100 steps with K5 launched once per step and K2 nine times.
The second-to-last line is the card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0), and
without a CUDA device the script exits non-zero before printing a result.
"""
import argparse
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
# the Laue step's K2 launch at a random permute of a 10M-entry table, and
# its row in the kernels line
LAUE_PERM_PAIR = "image cotangent by perm"
LAUE_PERM_ROW = "gather_laue_image_perm"
# host_us calls at the Laue shapes: few enough that a device slower than
# the host does not fill the launch queue
LAUE_HOST_CALLS = 300
# K2 launches per step of each slice (the gathers of ops/plan_gather.py)
GATHERS_PER_STEP = {"default": 7, "a": 14, "b": 14, "image_layers": 3,
                    "bf16": 7, "image_layers_bf16": 3, "laue": 9, "wide": 7}

# the mono defaults of the CLI, copied from careless_tpu/args/*.py
MONO_DEFAULTS = dict(
    mc_samples=1, structure_factor_init_scale=1.0, epsilon=1e-7,  # common.py
    freeze_structure_factors=False,                               # common.py
    studentt_likelihood_dof=None, refine_uncertainties=False,     # likelihood.py
    learning_rate=1e-3, beta_1=0.9, beta_2=0.99, clipnorm=None,   # optimizer.py
    clipvalue=None, global_clipnorm=None,                         # optimizer.py
    kl_weight=None, wilson_prior_b=None, parents=None,            # prior.py
    analytic_kl=False,                                            # prior.py
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
    launches per call (the count captured over reps, rounded; a stray
    record rounds to 0), and a capture without a device event is taken
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
                and round(e.count / reps) >= 1]
        for e in seen:
            CAPTURED["records"] += e.count
            CAPTURED["launches"] += reps * round(e.count / reps)
        if seen:
            return {e.key: e.self_device_time_total / e.count
                    * round(e.count / reps) for e in seen}
    return None


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
               n_layers=N_LAYERS, width=None, reps=30):
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
    gives its largest difference from the routed kernel."""
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
    bit the same from two calls; then the head f32 row at the `wide`
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

    x = torch.randn(N_OBS, D_META, generator=gen, device=dev)
    rows = trunk_rows(torch, gen, x, peak_flops, peak_bw,
                      width=WIDE_SLICE["mlp_width"], reps=10)
    print("trunk_wide at the wide slice's shape: " + json.dumps(rows),
          flush=True)
    table.update(rows)
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
    against K3's (bitwise); times for the normal kind (slice (a)) and the
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


def model_on(device, seed, n_obs, n_refl, n_images, d_meta, n_layers,
             flags=None, laue=False, times=None):
    """The model of the CLI's defaults with `flags` on top, built by
    DataManager.build_model on `device` (None: the card), on rows sorted by
    refl_id (mono) or in the harmonic-chain layout (Laue), with plans.
    `times`, when given, receives the host seconds of each set-up step."""
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.models.base import Inputs

    times = {} if times is None else times
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        times[name] = t1 - t0
        t0 = t1

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
    inputs = inputs.with_plans(dm.n_refl, dm.n_images)
    lap("plans_s")
    return model, params, trainer, inputs, f_true


def grad_rel_err(g_a, g_b):
    """The largest per-tensor error relative to the tensor's largest entry."""
    return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(g_a, g_b))


def check_phase(torch, dev, seed, flags=None, label="default"):
    """Loss and every parameter gradient of the port at a small size on
    the card (kernels) against the same computation on the CPU (plain
    versions), at the same parameters, uniforms and noise (mc = 1), for
    the CLI defaults with `flags` on top."""
    from careless_tpu_torch.models.merging.variational import (
        flatten_params, map_params)
    from careless_tpu_torch.utils.params import (params_from_jax,
                                                 params_to_numpy)

    sizes = (20_000, 2_000, 50, D_META, N_LAYERS)
    rng = np.random.default_rng(seed + 1)
    u_f = rng.random(sizes[1]).astype(np.float32)
    eps = rng.standard_normal(sizes[0]).astype(np.float32)
    results = []
    for device in ("cpu", dev):
        model, params, _, inputs, _ = model_on(device, seed, *sizes,
                                               flags=flags)
        if not results:
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
    print(f"check ({label}, {type(model.scaler).__name__}): loss "
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
    held, perm_row = laue_kernels(torch, dev, gen, inputs, peak_flops,
                                  peak_bw)
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


def laue_kernels(torch, dev, gen, inputs, peak_flops, peak_bw):
    """Each kernel the Laue step launches besides K5 (k5_case holds that),
    held against its plain version at this run's shapes and timed, at
    kernel_phase's tolerances: K1 on the inputs' metadata, K3 for the
    step's N normals, and K2 at each (table, ids) pair of the step, on
    random tables of the step's sizes by the plans' own ids. Returns each
    kernel's largest error, and K2's row at the image cotangent's random
    permute (LAUE_PERM_PAIR), the step's one K2 launch whose table is
    too large to stay in L2 beside its ids and output."""
    import careless_tpu_torch.ops.plan_gather as pg

    n, plans = inputs.n_obs, inputs.plans
    refl, image = plans.refl, plans.image
    n_refl, n_images = refl.table_size, image.table_size
    m = (n + pg._CHUNK) // pg._CHUNK   # segment-sum chunks over N entries
    rows = trunk_rows(torch, gen, inputs.metadata, peak_flops, peak_bw)
    pairs = {
        "z_f by sigma (forward permute)": (n_refl, refl.sigma),
        "permuted z_f by renumbered refl_id": (n_refl, refl.inner.ids),
        "refl segment-sum boundaries": (m * pg._CHUNK, refl.inner.pos),
        "refl chunk prefixes": (2 * m, refl.inner.cp_ids),
        "cotangent by sigma_inv (backward permute)": (n_refl,
                                                      refl.sigma_inv),
        "image scales by image_id": (n_images, image.ids),
        LAUE_PERM_PAIR: (n, image.perm),
        "image segment-sum boundaries": (m * pg._CHUNK, image.pos),
        "image chunk prefixes": (2 * m, image.cp_ids),
    }
    check(image.perm is not None, "Laue: the image ids are sorted; the "
          "step has no image cotangent permute")
    gathers = {label: gather_row(torch, gen, size, ids, label, peak_flops,
                                 peak_bw, calls=LAUE_HOST_CALLS)
               for label, (size, ids) in pairs.items() if ids is not None}
    rows["philox_normal"] = philox_row(torch, dev, gen, n, 0, peak_flops,
                                       peak_bw)
    print(f"laue kernels at {n} observations: " + json.dumps(
        {**rows, "gather": gathers}), flush=True)
    held = {k: v["max_abs_err"] for k, v in rows.items()}
    held["gather"] = max(v["max_abs_err"] for v in gathers.values())
    return held, dict(gathers[LAUE_PERM_PAIR], launch_site=(
        f"{LAUE_PERM_PAIR}: one of the Laue step's "
        f"{GATHERS_PER_STEP['laue']} K2 launches; launches counts all K2 "
        "launches of the Laue run"))


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


def profile_steps(torch, trainer, params, inputs, seed, ms_per_step,
                  steps=20):
    """Device time per step by kernel (torch.profiler, CUPTI) over a short
    window; the busy share is that device time over the unprofiled step
    time measured above (one stream, so kernels do not overlap); returns
    what it prints."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from careless_tpu_torch.device import seeded_generator

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train(params, seeded_generator(seed + 1, inputs.device),
                      inputs, steps, chunk_size=steps)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies); host ranges and their
        # device-side annotations would count the same time twice
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.self_device_time_total / 1e3 / steps,
                         e.count / steps, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    out = dict(device_ms_per_step=device_ms,
               busy_share=device_ms / ms_per_step if device_ms else None,
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
                                           mlp_dtype="bfloat16")}.items():
        check_phase(torch, dev, args.seed, flags, label)
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

    rows["gather_stream"], launches_laue, held, rows[LAUE_PERM_ROW] = \
        laue_phase(torch, dev, gen, args.seed, peak_flops, peak_bw)
    for k, err in held.items():
        rows[k]["laue_max_abs_err"] = err
    again = launch_phase(torch, dev, gen, steps=False)
    rows["gather"]["launch_path_host_us_after_profiling"] = again
    for kname, key in K4_HOST.items():
        rows[kname]["host_us_after_profiling"] = again[key]
    print("profiler: kernel records captured of the launches device_ms "
          "timed: " + json.dumps(CAPTURED), flush=True)

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
