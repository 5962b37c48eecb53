#!/usr/bin/env python3
"""csrc/trunk_wide.cu (K1 at kernel widths 33-128, or past a block's shared
memory) on the card, without building the rest of the port's kernels.

    python3 tools/trunk_wide_probe.py [--old DIR] [--no-ablate]

Compiles csrc/trunk_wide.cu and csrc/trunk.cu alone (tools/probe_build.py,
the port's nvcc flags) into build/trunk_wide_probe/ (under a minute of
nvcc), and prints ptxas' register, shared-memory and spill lines
of the two wide kernels and the counts of their shared-memory, FMA, async
copy and barrier instructions (cuobjdump -sass: LDS.128 are 16-byte loads,
LDGSTS cp.async). With --old DIR (the root of a checkout whose
csrc/trunk_wide.cu is of the earlier design, OLD, e.g. a `git archive` of
the commit before the redesign) the same for DIR's source, launched by
OLD's arithmetic, and every measurement below for both, in turns on the
same card.

Then one JSON line per shape (SHAPES: the `wide` slice's 1M rows, d_in 10,
width 128, 20 layers, head f32, and 100k rows at widths 48, 64 and 128):
each build's forward and backward held against the plain version
(ops/fused_mlp.py, autograd for the backward) within chip_smoke.trunk_rows'
1e-4 of the output scale and of the gradients' largest entry, dW and db
bitwise repeatable, the forwards of the two builds bit for bit equal (both
sum each output in K1-fwd's order), and device milliseconds per call
(chip_smoke.device_ms, the profiler's kernel time) beside chip_smoke's f32
bound. Last, unless --no-ablate, the backward at the `wide` slice's shape
with one part knocked out at a time (ABLATIONS, and OLD's for --old:
rewritten copies of the source, each pattern asserted present; their
results are wrong and only their times are kept): what each part of the
backward costs.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from careless_tpu_torch import kernels  # noqa: E402
from careless_tpu_torch.kernels import _build  # noqa: E402
from careless_tpu_torch.ops.fused_mlp import (pack_params,  # noqa: E402
                                              plain_trunk_head)
from tools import probe_build  # noqa: E402

OUT = ROOT / "build" / "trunk_wide_probe"
LEAK = 0.01
# (label, observations, d_in, width, layers)
SHAPES = (("wide slice", 1_000_000, 10, 128, 20),
          ("100k, width 48", 100_000, 10, 48, 20),
          ("100k, width 64", 100_000, 10, 64, 20),
          ("100k, width 128", 100_000, 10, 128, 20))
KERNELS = {"trunk_wide_fwd_kernel": "forward",
           "trunk_wide_bwd_kernel": "backward"}

# Ablations of the backward: each knocks one part out by rewriting a copy
# of the source (wrong results, kept only for their times); a pattern that
# the source no longer holds fails the build.
ABLATIONS = {
    "recompute alone": (
        ("    // the chain back, layer by layer",
         "    if (tile >= 0) continue;\n"
         "    // the chain back, layer by layer"),),
    "no dh": (
        ("        dh_product(acc, dp, sw, 0, s, bf16);",
         "        zero(acc);"),),
    "no dW sums": (
        ("      tile_sums(pw + w_offset(l, d_in, width)",
         "      if (false) tile_sums(pw + w_offset(l, d_in, width)"),),
    "no partial read-modify-write": (
        ("                          ? ld4(pw + k * width + col)",
         "                          ? make_float4(0.f, 0.f, 0.f, 0.f)"),
        ("          if (k < k_in && col < width)\n"
         "            st4(pw + k * width + col,",
         "          if (sum[0] == 1.25e-37f)\n"
         "            st4(pw + k * width + col,"),),
}
# The earlier design (64-row tiles, 4 x 4 outputs a thread, 4 kw threads
# a block, partials `size` floats apart), probed with --old DIR beside
# this one: a line only its source holds, its launch arithmetic and its
# ablations.
OLD = dict(
    marker="constexpr int GROUPS = 16;", rows=64, threads=lambda kw: 4 * kw,
    ablations={
        "recompute alone": (
            ("    float* dh = a == bufs[0] ? bufs[1] : bufs[0];",
             "    if (tile >= 0) continue;\n"
             "    float* dh = a == bufs[0] ? bufs[1] : bufs[0];"),),
        "no dh": (
            ("dh_tile(dh, nullptr, dp, sw, s.kw, s.kw, first, n, s, "
             "bf16);", "(void)0;"),),
        "no dW sums": (
            ("      tile_sums(pw + w_offset(l, d_in, width)",
             "      if (false) tile_sums(pw + w_offset(l, d_in, width)"),),
        "no partial read-modify-write": (
            ("? pw[(4 * kq + m) * width + 4 * jq + j] : 0.f;",
             "? 0.f : 0.f;"),
            ("pw[k * width + 4 * jq + j] = old[m][j] + acc[m][j];",
             "if (acc[m][j] == 1.25e-37f) pw[k * width + 4 * jq + j] "
             "= old[m][j] + acc[m][j];"),),
    })


def bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ct_trunk_wide_fwd.argtypes = [P] * 5 + [I] * 7 + [F, P]
    lib.ct_trunk_wide_bwd.argtypes = [P] * 9 + [I] * 8 + [F, P]
    lib.ct_trunk_wide_smem.argtypes = [I, I, I]
    lib.ct_trunk_wide_smem.restype = ctypes.c_size_t
    return lib


def compile_all(jobs):
    """jobs: {tag: (csrc dir, source text of trunk_wide.cu)}; compiles each
    with csrc/trunk.cu of its dir into OUT/tag/, all nvcc processes at
    once; returns {tag: (library, trunk_wide object, ptxas log)}."""
    objs = {}
    for tag, (csrc, text) in jobs.items():
        out = OUT / tag
        out.mkdir(parents=True, exist_ok=True)
        (out / "trunk_wide.cu").write_text(text)
        objs[tag] = {out / "trunk_wide.o": (out / "trunk_wide.cu", csrc),
                     out / "trunk.o": (csrc / "trunk.cu", csrc)}
    logs = probe_build.compile_objects(
        {obj: job for parts in objs.values() for obj, job in parts.items()})
    built = {}
    for tag, parts in objs.items():
        log = "\n".join(logs[obj] for obj in parts)
        (OUT / tag / "build.log").write_text(log)
        built[tag] = (bind(probe_build.link(list(parts),
                                            OUT / tag / "probe.so")),
                      OUT / tag / "trunk_wide.o", log)
    return built


class Build:
    """One compiled csrc/trunk_wide.cu: this checkout's, whose grid and
    scratch are the launcher's (kernels._wide_bwd_scratch), or (old) the
    earlier design's, by OLD's launch arithmetic."""

    def __init__(self, tag, lib, old=False):
        self.tag, self.lib, self.old = tag, lib, old

    def scratch(self, n, d, w, L, size, dev):
        """The backward's blocks, partials and stash."""
        if not self.old:
            return kernels._wide_bwd_scratch(n, d, w, L, size, 0, dev)
        kw = -(-w // 16) * 16
        smem = self.lib.ct_trunk_wide_smem(d, w, 1)
        per_sm = max(1, min(kernels.SMEM_PER_SM // (smem + 1024),
                            2048 // OLD["threads"](kw)))
        blocks = max(1, min(-(-n // OLD["rows"]),
                            per_sm * kernels._sm_count(0)))
        return (blocks, torch.empty((blocks, size), device=dev),
                torch.empty(blocks * max(L - 1, 1) * OLD["rows"] * kw,
                            device=dev))

    def fwd(self, x, w, b, width, L, stream):
        n, d = x.shape
        outs = (torch.empty(n, device=x.device),
                torch.empty(n, device=x.device))

        def run():
            err = self.lib.ct_trunk_wide_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), n, d, width, L, 1, 0, 0, LEAK, stream)
            assert err == 0, (self.tag, "forward", err)
            return outs
        return run

    def bwd(self, x, w, b, dys, width, L, stream):
        n, d = x.shape
        size = w.numel() + b.numel()
        blocks, part, stash = self.scratch(n, d, width, L, size, x.device)
        res = torch.empty(size, device=x.device)

        def run():
            err = self.lib.ct_trunk_wide_bwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), dys[0].data_ptr(),
                dys[1].data_ptr(), None, part.data_ptr(), stash.data_ptr(),
                res.data_ptr(), n, d, width, L, 1, 0, 0, blocks, LEAK,
                stream)
            assert err == 0, (self.tag, "backward", err)
            return res
        return run
def shape_line(builds, stream, gen, label, n, d, w, L, peaks):
    """Both directions of each build at one shape (head, f32), held against
    the plain version and each other, and timed."""
    dev = torch.device("cuda", 0)
    x = torch.randn(n, d, generator=gen, device=dev)
    layers, out = cs.random_trunk(torch, gen, d, w, L, dev)
    kw = kernels.trunk_width(w)
    wflat, bflat = (t.detach().contiguous()
                    for t in pack_params(layers, out, kw))
    dys = (torch.randn(n, generator=gen, device=dev),
           torch.randn(n, generator=gen, device=dev))
    leaves = [t for layer in layers for t in (layer["w"], layer["b"])]
    leaves += [out["w"], out["b"]]
    ys = plain_trunk_head(x, layers, out, LEAK)
    scale = max(max(y.abs().max().item() for y in ys), 1.0)
    g = torch.autograd.grad(sum((y * c).sum() for y, c in zip(ys, dys)),
                            leaves)
    del ys
    # the flat layout: every weight (the head's last), then every bias
    want = torch.cat([t.reshape(-1) for t in g[0::2] + g[1::2]])
    gscale = want.abs().max().item()
    del g
    cases, fwd_outs = {}, {}
    for bld in builds:
        fwd = bld.fwd(x, wflat, bflat, kw, L, stream)
        bwd = bld.bwd(x, wflat, bflat, dys, kw, L, stream)
        got = [t.clone() for t in fwd()]
        fwd_outs[bld.tag] = got
        g1, g2 = bwd().clone(), bwd().clone()
        reps = 3 if n >= 1_000_000 else 10
        cases[bld.tag] = dict(
            fwd_max_abs_err=max((a - b).abs().max().item()
                                for a, b in zip(got, plain_trunk_head(
                                    x, layers, out, LEAK))),
            fwd_tolerance=1e-4 * scale,
            bwd_max_abs_err=(g1 - want).abs().max().item(),
            bwd_tolerance=1e-4 * gscale,
            bwd_bitwise_repeatable=torch.equal(g1, g2),
            fwd_device_ms=cs.device_ms(torch, fwd, reps=reps),
            bwd_device_ms=cs.device_ms(torch, bwd, reps=reps),
            smem_fwd=bld.lib.ct_trunk_wide_smem(d, kw, 0),
            smem_bwd=bld.lib.ct_trunk_wide_smem(d, kw, 1),
            bwd_blocks=bld.scratch(n, d, kw, L, 0, dev)[0])
        cases[bld.tag]["ok"] = (
            cases[bld.tag]["fwd_max_abs_err"] <= 1e-4 * scale
            and cases[bld.tag]["bwd_max_abs_err"] <= 1e-4 * gscale
            and cases[bld.tag]["bwd_bitwise_repeatable"])
        del g1, g2
    if len(fwd_outs) == 2:
        a, b = fwd_outs.values()
        cases["forwards_bit_for_bit_equal"] = all(
            torch.equal(p, q) for p, q in zip(a, b))
    F = d * w + (L - 1) * w * w + 2 * w
    nb = L * w + 2
    fb = cs.bound(2.0 * n * F, 4.0 * (n * d + 2 * n + F + nb),
                  peaks[0], peaks[1])
    bb = cs.bound(2.0 * n * (3 * F - d * w),
                  4.0 * (n * d + 2 * n + 2 * (F + nb)), peaks[0], peaks[1])
    print(json.dumps(dict(shape=label, n=n, d_in=d, width=w, n_layers=L,
                          head=True, bf16=False, fwd_bound_ms=fb[0],
                          bwd_bound_ms=bb[0], bound_by=bb[1], cases=cases)),
          flush=True)
    return cases


def ablations_of(bld):
    return OLD["ablations"] if bld.old else ABLATIONS


def ablate(jobs, builds, stream, gen):
    """Device ms of each build's backward at the `wide` slice's shape,
    whole and with each of its design's ablations (ABLATIONS, or OLD's)."""
    _, n, d, w, L = SHAPES[0]
    ab_jobs = {}
    for bld in builds:
        csrc, src = jobs[bld.tag]
        for i, (name, subs) in enumerate(ablations_of(bld).items()):
            text = src
            for old, new in subs:
                assert old in text, (bld.tag, name, old)
                text = text.replace(old, new)
            ab_jobs[f"{bld.tag}-ablation{i}"] = (csrc, text)
    libs = compile_all(ab_jobs)
    dev = torch.device("cuda", 0)
    x = torch.randn(n, d, generator=gen, device=dev)
    layers, out = cs.random_trunk(torch, gen, d, w, L, dev)
    wflat, bflat = (t.detach().contiguous()
                    for t in pack_params(layers, out, w))
    dys = (torch.randn(n, generator=gen, device=dev),
           torch.randn(n, generator=gen, device=dev))
    for bld in builds:
        times = {"whole": cs.device_ms(
            torch, bld.bwd(x, wflat, bflat, dys, w, L, stream), reps=3)}
        for i, name in enumerate(ablations_of(bld)):
            lib = libs[f"{bld.tag}-ablation{i}"][0]
            times[name] = cs.device_ms(torch, Build(
                bld.tag, lib, bld.old).bwd(x, wflat, bflat, dys, w, L,
                                           stream), reps=3)
        print(f"ablations of the {bld.tag} backward at the wide slice's "
              "shape, device ms: " + json.dumps(times), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help="root of another checkout whose csrc/trunk_wide.cu "
                    "is probed beside this one")
    ap.add_argument("--no-ablate", action="store_true")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the registers and SASS counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trunk_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {"new": (_build.CSRC, (_build.CSRC / "trunk_wide.cu").read_text())}
    if args.old:
        csrc = args.old.resolve() / "careless_tpu_torch" / "csrc"
        jobs["old"] = (csrc, (csrc / "trunk_wide.cu").read_text())
        assert OLD["marker"] in jobs["old"][1], \
            "--old DIR's csrc/trunk_wide.cu is not of the earlier design"
    built = compile_all(jobs)
    builds = []
    for tag, (lib, obj, log) in built.items():
        for label, line in probe_build.ptxas_lines(log, KERNELS):
            print(f"ptxas, {tag} {label}: {line}", flush=True)
        print(f"sass, {tag}: " + json.dumps(probe_build.sass_counts(
            obj, KERNELS, OUT / tag / "trunk_wide.sass")), flush=True)
        builds.append(Build(tag, lib, old=tag == "old"))
    print(cs.card_line(), flush=True)
    if args.build_only:
        return 0
    name = torch.cuda.get_device_name(0)
    peaks = cs.peaks(name)
    stream = torch.cuda.current_stream(0).cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for label, n, d, w, L in SHAPES:
        # the old build second at each shape, then first at the next
        cases = shape_line(builds, stream, gen, label, n, d, w, L, peaks)
        builds.reverse()
        ok &= all(c["ok"] for k, c in cases.items() if isinstance(c, dict))
        ok &= cases.get("forwards_bit_for_bit_equal", True)
        torch.cuda.empty_cache()
    if not args.no_ablate:
        ablate(jobs, builds, stream, gen)
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
