#!/usr/bin/env python3
"""csrc/trunk.cu's forward (the narrow K1-fwd) on the card, without building
the rest of the port's kernels.

    python3 tools/trunk_fwd_probe.py [--old DIR] [--variants] [--build-only]

Compiles csrc/trunk.cu alone (tools/probe_build.py, the port's nvcc flags)
into build/trunk_fwd_probe/new/ (with --old DIR, DIR's csrc/trunk.cu too,
into .../old/; DIR is the root of another checkout, e.g. a `git archive` of
the parent commit unpacked under build/), and prints for each build ptxas'
register, shared-memory and spill lines of the forward at widths 10, 12,
16, 24, 28 and 32, and the instruction counts of its kernel at width 10
(cuobjdump -sass; whole kernel and the loop bodies with the most FFMA: LDS
by width, FFMA, the bias and leaky ReLU's FADD, FMUL, FSETP, FSEL and
FMNMX, bf16 rounding's F2FP, LDG, STG, BAR, LDC and ULDC). The whole SASS
lands in build/trunk_fwd_probe/<tag>/trunk.sass.

Then one JSON line per case: the main path's shape (1M rows, d_in = width
= 10, 20 layers) in all four instantiations (head or trunk only, f32 or
bf16) and the Laue step's (10M rows, head, f32), each build held against
the plain version (ops/fused_mlp.py, bf16 for bf16) within chip_smoke's
1e-4 of the output scale, the builds bit for bit equal to each other (all
sum each output in K1-fwd's order), and device milliseconds per call
(chip_smoke.device_ms, the profiler's kernel time) beside chip_smoke's
bound and the f32 operations bound (the floor of every instantiation on
the SIMT units). Builds take turns at each case (old, new, then new, old
at the next). A depth sweep (1M, head f32, at 5 and 10 layers beside the
20 above) splits each build's time into a part per layer and a fixed
part. With --variants, rewritten copies of this checkout's source
(VARIANTS: other rows a thread, the trunk-only output through shared
memory, x loads; each pattern asserted present) are timed beside it at
the main path's shape in the four instantiations. At the main path's head
f32 case each build's SM clock and power draw under load are printed
beside its time. Exits 1 if a build disagrees with plain or with another.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from careless_tpu_torch import kernels  # noqa: E402
from careless_tpu_torch.kernels import _build  # noqa: E402
from careless_tpu_torch.ops.fused_mlp import (pack_params,  # noqa: E402
                                              plain_trunk, plain_trunk_head)
from tools import probe_build  # noqa: E402

OUT = ROOT / "build" / "trunk_fwd_probe"
LEAK = 0.01
# (label, rows, d_in, width, layers, [(head, bf16), ...])
CASES = (("1M", 1_000_000, 10, 10, 20, cs.TRUNK_VARIANTS),
         ("10M (Laue)", 10_000_000, 10, 10, 20, ((True, False),)),
         ("1M, 10 layers", 1_000_000, 10, 10, 10, ((True, False),)),
         ("1M, 5 layers", 1_000_000, 10, 10, 5, ((True, False),)))
# symbol fragments of the forward at six widths (the mangled template
# argument), for ptxas' lines; the SASS is counted at the first
WIDTHS = {f"trunk_fwd_kernelILi{w}E": f"forward, width {w}"
          for w in (10, 12, 16, 24, 28, 32)}
KINDS = probe_build.COUNTED + ("FADD", "FMUL", "FSETP", "FSEL", "FMNMX",
                               "F2FP", "LDC", "ULDC")
# Rewritten copies of this checkout's csrc/trunk.cu, built and timed
# beside it with --variants: {name: ((pattern, replacement), ...)}
TRUNK_TILE_SMEM = (
    "  return sizeof(float) * (n_weights(d_in, W, L, head) + "
    "n_biases(W, L, head));",
    "  return sizeof(float) * (n_weights(d_in, W, L, head) + "
    "n_biases(W, L, head) + (head ? 0 : FWD_WARPS * 32 * fwd_rows(W) * "
    "(W | 1)));")
TRUNK_TILE_STORE = (
    """      for (int r = 0; r < R; ++r) {
        if (lane + 32 * r < rows) {
          float* o = out0 + (first + lane + 32 * r) * out_w;
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (j < out_w) o[j] = h[r][j];
        }
      }""",
    """      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < W; ++j)
          smem[nw + nb + ((threadIdx.x >> 5) * ROWS + lane + 32 * r) *
               (W | 1) + j] = h[r][j];
      __syncwarp();
      float* o = out0 + first * out_w;
      for (int i = lane; i < rows * out_w; i += 32)
        o[i] = smem[nw + nb + ((threadIdx.x >> 5) * ROWS + i / out_w) *
                    (W | 1) + i % out_w];
      __syncwarp();""")
R8 = (("return W <= 10 ? 4 : W <= 20 ? 2 : 1;",
       "return W <= 10 ? 8 : W <= 20 ? 2 : 1;"),
      ("constexpr int FWD_WARPS_PER_SM = 16;",
       "constexpr int FWD_WARPS_PER_SM = 8;"))
VARIANTS = {
    "8 rows a thread at width 10, 1 block of 8 warps a SM": R8,
    "trunk only: the output through a tile of the warp's rows": (
        TRUNK_TILE_SMEM, TRUNK_TILE_STORE),
    "both": R8 + (TRUNK_TILE_SMEM, TRUNK_TILE_STORE),
    "x read 2 columns a step": (("#pragma unroll 4\n      for (int k = 0;",
                                 "#pragma unroll 2\n      for (int k = 0;"),),
    "x read 8 columns a step": (("#pragma unroll 4\n      for (int k = 0;",
                                 "#pragma unroll 8\n      for (int k = 0;"),),
}


class Build:
    """One compiled csrc/trunk.cu's forward: this checkout's design,
    launched by kernels.trunk_fwd_blocks' arithmetic on the library's own
    rows a thread, warps a block and a SM, and shared-memory sum (so a
    variant launches as its source says; for this checkout's source the two
    agree); or the earlier design (a thread a row in blocks of 128, a block
    per 128 rows), told apart by the library's symbols."""

    def __init__(self, tag, lib):
        self.tag, self.lib = tag, lib
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.new = hasattr(lib, "ct_trunk_fwd_rows")
        lib.ct_trunk_fwd.argtypes = [P] * 5 + [I] * (8 if self.new else 7) \
            + [F, P]
        if self.new:
            lib.ct_trunk_smem.argtypes = [I] * 5
            lib.ct_trunk_smem.restype = ctypes.c_size_t
            lib.ct_trunk_fwd_rows.argtypes = [I]
            lib.ct_trunk_fwd_limits.argtypes = [P, P]
            lib.ct_trunk_fwd_limits.restype = None

    def blocks(self, n, d, w, L, head):
        """The grid of this build's forward."""
        lib = self.lib
        warps, per = ctypes.c_int(), ctypes.c_int()
        lib.ct_trunk_fwd_limits(ctypes.byref(warps), ctypes.byref(per))
        smem = lib.ct_trunk_smem(d, w, L, int(head), 0)
        per_sm = min(per.value // warps.value,
                     kernels.SMEM_PER_SM // (smem + 1024))
        tiles = -(-n // (32 * lib.ct_trunk_fwd_rows(w)))
        return max(1, min(-(-tiles // warps.value),
                          per_sm * kernels._sm_count(0)))

    def fwd(self, x, wflat, bflat, width, L, head, bf16, stream):
        n, d = x.shape
        dev = x.device
        outs = ((torch.empty(n, device=dev), torch.empty(n, device=dev))
                if head else (torch.empty(n, width, device=dev),))
        args = [x.data_ptr(), wflat.data_ptr(), bflat.data_ptr(),
                outs[0].data_ptr(), outs[-1].data_ptr() if head else None,
                n, d, width, L, int(head), width, int(bf16)]
        if self.new:
            args.append(self.blocks(n, d, width, L, head))

        def run():
            err = self.lib.ct_trunk_fwd(*args, LEAK, stream)
            assert err == 0, (self.tag, "forward", err)
            return outs
        return run


def compile_all(jobs):
    """jobs: {tag: (csrc dir, source text of trunk.cu)}; compiles each into
    OUT/tag/, all nvcc processes at once; returns {tag: (Build, object,
    ptxas log)}."""
    objs = {}
    for tag, (csrc, text) in jobs.items():
        out = OUT / tag
        out.mkdir(parents=True, exist_ok=True)
        (out / "trunk.cu").write_text(text)
        objs[tag] = out / "trunk.o"
    logs = probe_build.compile_objects(
        {obj: (obj.with_suffix(".cu"), jobs[tag][0])
         for tag, obj in objs.items()})
    built = {}
    for tag, obj in objs.items():
        (OUT / tag / "build.log").write_text(logs[obj])
        built[tag] = (Build(tag, probe_build.link([obj],
                                                  OUT / tag / "probe.so")),
                      obj, logs[obj])
    return built


def report(built):
    for tag, (bld, obj, log) in built.items():
        for label, line in probe_build.ptxas_lines(log, WIDTHS):
            print(f"ptxas, {tag} {label}: {line}", flush=True)
        key = next(iter(WIDTHS))
        counts = probe_build.sass_counts(obj, {key: WIDTHS[key]},
                                         OUT / tag / "trunk.sass",
                                         kinds=KINDS, loops=6)
        print(f"sass, {tag}: " + json.dumps(counts), flush=True)


def under_load(run, calls=10_000):
    """The SM clock (now and its maximum) and power draw nvidia-smi reads
    while `calls` launches of run are queued on the card."""
    for _ in range(calls):
        run()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


def case_line(builds, stream, gen, label, n, d, w, L, head, bf16, peaks,
              clocks=False):
    """Each build's forward at one case, against plain and each other;
    with clocks, each build's SM clock under load (under_load)."""
    dev = torch.device("cuda", 0)
    x = torch.randn(n, d, generator=gen, device=dev)
    layers, out = cs.random_trunk(torch, gen, d, w, L, dev)
    wflat, bflat = (t.detach().contiguous() for t in pack_params(
        layers, out if head else None, w))
    with torch.no_grad():
        ys = (plain_trunk_head(x, layers, out, LEAK, bf16=bf16) if head
              else (plain_trunk(x, layers, LEAK, bf16=bf16),))
    scale = max(max(y.abs().max().item() for y in ys), 1.0)
    res, outs = {}, {}
    reps = 30 if n <= 1_000_000 else 10
    for bld in builds:
        run = bld.fwd(x, wflat, bflat, w, L, head, bf16, stream)
        got = [t.clone() for t in run()]
        outs[bld.tag] = got
        err = max((a - b).abs().max().item() for a, b in zip(got, ys))
        res[bld.tag] = dict(max_abs_err=err, tolerance=1e-4 * scale,
                            ok=err <= 1e-4 * scale,
                            device_ms=cs.device_ms(torch, run, reps=reps),
                            ms=cs.time_ms(torch, run, reps=reps))
        if clocks:
            res[bld.tag]["clocks_under_load"] = under_load(run)
        if bld.new:
            res[bld.tag]["blocks"] = bld.blocks(n, d, w, L, head)
    del ys
    tags = list(outs)
    res["bit_for_bit_equal"] = all(
        torch.equal(p, q) for t in tags[1:]
        for p, q in zip(outs[tags[0]], outs[t]))
    F = d * w + (L - 1) * w * w + (2 * w if head else 0)
    nb = L * w + (2 if head else 0)
    nbytes = 4.0 * (n * d + n * (2 if head else w) + F + nb)
    ops_peak = cs.bf16_peak(torch.cuda.get_device_name(0)) if bf16 \
        else peaks[0]
    b_ms, b_by = cs.bound(2.0 * n * F, nbytes, ops_peak, peaks[1])
    print(json.dumps(dict(
        case=label, n=n, d_in=d, width=w, n_layers=L, head=head, bf16=bf16,
        bound_ms=b_ms, bound_by=b_by,
        f32_bound_ms=cs.bound(2.0 * n * F, nbytes, *peaks)[0], builds=res)),
        flush=True)
    return all(r["ok"] for k, r in res.items() if isinstance(r, dict)) \
        and res["bit_for_bit_equal"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help="root of another checkout whose csrc/trunk.cu's "
                    "forward is probed beside this one")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time VARIANTS of this source")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the registers and SASS counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trunk_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    src = (_build.CSRC / "trunk.cu").read_text()
    jobs = {"new": (_build.CSRC, src)}
    if args.old:
        csrc = args.old.resolve() / "careless_tpu_torch" / "csrc"
        jobs["old"] = (csrc, (csrc / "trunk.cu").read_text())
    if args.variants:
        for i, (name, subs) in enumerate(VARIANTS.items()):
            text = src
            for old, new in subs:
                assert old in text, (name, old)
                text = text.replace(old, new)
            jobs[f"variant{i}"] = (_build.CSRC, text)
            print(f"variant{i}: {name}", flush=True)
    built = compile_all(jobs)
    report(built)
    print(cs.card_line(), flush=True)
    if args.build_only:
        return 0
    peaks = cs.peaks(torch.cuda.get_device_name(0))
    stream = torch.cuda.current_stream(0).cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_builds = [built[t][0] for t in ("old", "new") if t in built]
    if main_builds[-1].new:
        new = main_builds[-1]
        for args_ in ((1_000_000, 10, 10, 20, True), (5_001, 7, 20, 3, False),
                      (100_003, 128, 32, 20, True)):
            assert new.blocks(*args_) == kernels.trunk_fwd_blocks(
                *args_, kernels._sm_count(0)), args_
    ok = True
    for label, n, d, w, L, variants in CASES:
        for head, bf16 in variants:
            ok &= case_line(main_builds, stream, gen, label, n, d, w, L,
                            head, bf16, peaks, clocks=label == "1M"
                            and head and not bf16)
            main_builds.reverse()
            torch.cuda.empty_cache()
    if args.variants:
        everyone = [b for b, _, _ in built.values()]
        for head, bf16 in cs.TRUNK_VARIANTS:
            ok &= case_line(everyone, stream, gen, "1M, variants",
                            *CASES[0][1:5], head, bf16, peaks)
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
