#!/usr/bin/env python3
"""K1-bwd's kernels side by side on the card, without building the rest of
the port's kernels: the f32 backward (csrc/trunk_bwd.cu) and the bf16 one
on tensor cores (csrc/trunk_bwd_bf16.cu), each beside csrc/trunk.cu's
backward on the same inputs; and K3 (csrc/philox.cu) beside torch.randn.

    python3 tools/trunk_bwd_probe.py [--part f32|bf16|k3 ...]

Compiles csrc/trunk_bwd.cu, csrc/trunk_bwd_bf16.cu, csrc/trunk.cu and
csrc/philox.cu alone, with the port's nvcc flags (kernels/_build.py
NVCC_FLAGS), into build/trunk_bwd_probe/ (a minute of nvcc), prints ptxas'
register, shared-memory and spill lines of the f32 and bf16 kernels at
widths 10, 28 and 32, and the counts of their shared-memory, FMA and
tensor-core instructions (cuobjdump -sass: LDS.128 are 16-byte loads, LDSM
ldmatrix, HMMA mma). Then, per part (all three by default), one JSON line
per shape: at 1M observations of d = w = 10 over 20 layers (head and trunk
only), 10M (head), and 20 layers of width 28 over d_in 28 and width 32
over d_in 128 at 100k, the kernel that kernels.trunk_bwd_route names for
the operand type, at each block size of kernels.TRUNK_BWD_F32_TILES (f32)
or TRUNK_BWD_BF16_TILES (bf16) that fits (the route's is the first), and
csrc/trunk.cu's backward with the same bf16
flag; each held against the plain version (autograd through
plain_trunk_head or plain_trunk, bf16 for bf16) at chip_smoke.trunk_rows'
tolerance, 1e-4 of the gradients' largest entry, and against itself bit
for bit, with device milliseconds per call (chip_smoke.device_ms, the
profiler's kernel time), CUDA-event milliseconds, the warps per SM its
shared memory allows, and chip_smoke's bound (f32 at the f32 rate, bf16 at
the bf16 tensor-core rate). The f32 part ends with the f32 kernel at 1M
(head, width 10) over 20, 10 and 5 layers: warps per SM and device
microseconds per layer, which shows what residency is worth. The k3 part
holds K3 for 1M normals (offset 3M, as chip_smoke's row, and an unaligned
offset) against its plain version, words bitwise, and times it beside
torch.randn. The whole log of the build goes to
build/trunk_bwd_probe/build.log.
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
from tools import probe_build  # noqa: E402
from careless_tpu_torch.ops.fused_elbo import (  # noqa: E402
    plain_prng_normal)
from careless_tpu_torch.ops.fused_mlp import (pack_params,  # noqa: E402
                                              plain_trunk, plain_trunk_head)

OUT = ROOT / "build" / "trunk_bwd_probe"
LOG = OUT / "build.log"
LEAK = 0.01
# (label, observations, d_in, width, head)
SHAPES = (("1M head", 1_000_000, 10, 10, True),
          ("1M trunk only", 1_000_000, 10, 10, False),
          ("10M head", 10_000_000, 10, 10, True),
          ("width 28, d_in 28", 100_000, 28, 28, True),
          ("width 32, d_in 128", 100_000, 128, 32, True))


SOURCES = ("trunk_bwd.cu", "trunk_bwd_bf16.cu", "trunk.cu", "philox.cu")
# kernel symbols (mangled names) whose ptxas and SASS lines are printed
KERNELS = {f"{stem}_kernelILi{w}E": f"{label}, width {w}"
           for stem, label in (("trunk_bwd_f32", "f32 kernel"),
                               ("trunk_bwd_bf16", "bf16 kernel"))
           for w in (10, 28, 32)}
KERNELS["trunk_bwd_kernelILi10E"] = "trunk.cu backward, width 10"


def build():
    """The sources compiled at once, linked into one library; returns it
    and the objects' paths (for cuobjdump)."""
    objs = [OUT / (Path(name).stem + ".o") for name in SOURCES]
    log = "\n".join(probe_build.compile_objects({
        obj: (_build.CSRC / name, _build.CSRC)
        for obj, name in zip(objs, SOURCES)}).values())
    LOG.write_text(log)
    for label, line in probe_build.ptxas_lines(log, KERNELS):
        print(f"ptxas, {label}: {line}", flush=True)
    lib = probe_build.link(objs, OUT / "probe.so")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ct_trunk_bwd_f32.argtypes = [P] * 8 + [I] * 8 + [F, P]
    bind_bf16(lib)
    lib.ct_trunk_bwd.argtypes = [P] * 8 + [I] * 9 + [F, P]
    lib.ct_trunk_bwd_f32_smem.argtypes = [I] * 5
    lib.ct_trunk_bwd_f32_smem.restype = ctypes.c_size_t
    lib.ct_philox_normal.argtypes = [P, P, I, ctypes.c_uint32,
                                     ctypes.c_uint32, ctypes.c_uint64, P]
    return lib, objs


# Ablations of csrc/trunk_bwd_bf16.cu: each knocks one part of the kernel
# out by rewriting its source (wrong results, kept only for their times);
# a pattern that the source no longer holds fails the build
ABLATIONS = {
    "no dW (mma, ldmatrix, partial)": (
        ("dw_sums<KW>(", "if (false) dw_sums<KW>("),),
    "no dh (FMAs of dh)": (
        ("dh[k] = dot_j<W, KW>(dp, wl, k);", "dh[k] = dp[k];"),),
    "no db (shuffles)": (
        ("const float s = column_sums<KW>(v, lane);",
         "const float s = v[0];"),),
    "no recomputed hidden layers (FMAs)": (
        ("dense_layer<W>(h, h, layer_w(l + 1), sb + (l + 1) * W, leak);",
         "bias_leaky<W>(h, h, sb + (l + 1) * W, leak);"),),
}


def build_ablations():
    """{name: library} of csrc/trunk_bwd_bf16.cu with each of ABLATIONS
    applied, compiled at once from rewritten copies in build/."""
    src = (_build.CSRC / "trunk_bwd_bf16.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(ABLATIONS.items()):
        text = src
        for old, new in subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = OUT / f"ablation{i}.cu"
        cu.write_text(text)
        jobs[OUT / f"ablation{i}.o"] = (cu, _build.CSRC)
    probe_build.compile_objects(jobs)
    return {name: bind_bf16(probe_build.link(
        [OUT / f"ablation{i}.o"], OUT / f"ablation{i}.so"))
        for i, name in enumerate(ABLATIONS)}


def ablate(lib, stream, gen, n=1_000_000, width=10):
    """Device ms of the bf16 kernel at 1M (head, width 10, 20 layers, the
    route's block) whole and with each ablation: what each part costs."""
    dev, L = torch.device("cuda", 0), cs.N_LAYERS
    x = torch.randn(n, width, generator=gen, device=dev)
    dys = (torch.randn(n, generator=gen, device=dev),
           torch.randn(n, generator=gen, device=dev))
    layers, head = cs.random_trunk(torch, gen, width, width, L, dev)
    w, b = (t.detach().contiguous() for t in pack_params(layers, head, width))
    _, tile = kernels.trunk_bwd_route(width, width, L, True, True)
    smem = kernels.trunk_bwd_bf16_smem(width, width, L, True, tile)
    blocks = kernels._trunk_bwd_blocks(n, smem, tile, 0)
    part = torch.empty((blocks, w.numel() + b.numel()), device=dev)
    res = torch.empty(w.numel() + b.numel(), device=dev)
    out = {}
    for name, own in {"whole": lib, **build_ablations()}.items():
        def run():
            err = own.ct_trunk_bwd_bf16(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), dys[0].data_ptr(),
                dys[1].data_ptr(), None, part.data_ptr(), res.data_ptr(), n,
                width, width, L, 1, 0, tile, blocks, LEAK, stream)
            assert err == 0, (name, err)
        out[name] = cs.device_ms(torch, run, reps=20)
    print("bf16 ablations, 1M head, width 10, device ms: " + json.dumps(out),
          flush=True)


def bind_bf16(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ct_trunk_bwd_bf16.argtypes = [P] * 8 + [I] * 8 + [F, P]
    lib.ct_trunk_bwd_bf16_smem.argtypes = [I] * 5
    lib.ct_trunk_bwd_bf16_smem.restype = ctypes.c_size_t
    return lib


def sass_counts(objs):
    """Shared-memory, FMA, ldmatrix and mma instructions by kernel and
    width (KERNELS), from the SASS of the objects."""
    counts = {}
    for obj in objs:
        for kernel, ins in probe_build.sass(obj, KERNELS)[1].items():
            c = counts[kernel] = {}
            for _, op, _ in ins:
                if op.startswith(("LDS", "STS", "FFMA", "BAR", "LDSM",
                                  "HMMA", "SHFL")):
                    c[op] = c.get(op, 0) + 1
    return counts


def flat_leaves(wflat, bflat, d, w, L, head):
    """The plain version's layers as views of the flat packed parameters."""
    layers, off = [], 0
    for l in range(L):
        d_in = d if l == 0 else w
        layers.append({"w": wflat[off:off + d_in * w].view(d_in, w),
                       "b": bflat[l * w:(l + 1) * w]})
        off += d_in * w
    out = ({"w": wflat[off:off + 2 * w].view(w, 2),
            "b": bflat[L * w:L * w + 2]} if head else None)
    return layers, out


def depth_sweep(lib, stream, gen, n=1_000_000, width=10):
    """The f32 kernel at its route's block size over 20, 10 and 5 layers:
    blocks and warps per SM by shared memory, device us per layer."""
    dev = torch.device("cuda", 0)
    x = torch.randn(n, width, generator=gen, device=dev)
    dys = (torch.randn(n, generator=gen, device=dev),
           torch.randn(n, generator=gen, device=dev))
    out = {}
    for L in (20, 10, 5):
        layers, head = cs.random_trunk(torch, gen, width, width, L, dev)
        w, b = (t.detach().contiguous()
                for t in pack_params(layers, head, width))
        _, tile = kernels.trunk_bwd_route(width, width, L, True, False)
        smem = kernels.trunk_bwd_f32_smem(width, width, L, True, tile)
        blocks = kernels._trunk_bwd_blocks(n, smem, tile, 0)
        part = torch.empty((blocks, w.numel() + b.numel()), device=dev)
        res = torch.empty(w.numel() + b.numel(), device=dev)

        def run():
            err = lib.ct_trunk_bwd_f32(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), dys[0].data_ptr(),
                dys[1].data_ptr(), None, part.data_ptr(), res.data_ptr(), n,
                width, width, L, 1, 0, tile, blocks, LEAK, stream)
            assert err == 0, (L, err)
        per_sm = kernels.SMEM_PER_SM // (smem + 1024)
        ms = cs.device_ms(torch, run, reps=20)
        out[L] = dict(tile=tile, smem=smem, warps_per_sm=per_sm * tile // 32,
                      device_ms=ms,
                      us_per_layer=None if ms is None else 1e3 * ms / L)
    print("depth sweep, 1M head, width 10: " + json.dumps(out), flush=True)


def shape_cases(lib, stream, gen, label, n, d, w, head, bf16, peaks):
    """One JSON line for a shape and operand type: the routed kernel at each
    block size that fits and csrc/trunk.cu's backward, each held against
    the plain version and itself, and timed."""
    dev, idx, L = torch.device("cuda", 0), 0, cs.N_LAYERS
    route, rtile = kernels.trunk_bwd_route(d, w, L, head, bf16)
    x = torch.randn(n, d, generator=gen, device=dev)
    layers, out = cs.random_trunk(torch, gen, d, w, L, dev)
    wflat, bflat = (t.detach().contiguous() for t in pack_params(
        layers, out if head else None, w))
    del layers, out
    if head:
        dys = (torch.randn(n, generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev))
    else:
        dys = (torch.randn(n, w, generator=gen, device=dev),)
    nw, nb = wflat.numel(), bflat.numel()

    wl, bl = (t.clone().requires_grad_(True) for t in (wflat, bflat))
    lay, o = flat_leaves(wl, bl, d, w, L, head)
    ys = (plain_trunk_head(x, lay, o, LEAK, bf16=bf16) if head
          else (plain_trunk(x, lay, LEAK, bf16=bf16),))
    want = torch.cat(torch.autograd.grad(
        sum((y * c).sum() for y, c in zip(ys, dys)), [wl, bl]))
    del ys, lay, o, wl, bl
    gscale = want.abs().max().item()
    smem_of = (kernels.trunk_bwd_bf16_smem if bf16
               else kernels.trunk_bwd_f32_smem)

    def launcher(general, tile):
        smem = (kernels.trunk_smem if general else smem_of)(d, w, L, head,
                                                           tile)
        fn = lib.ct_trunk_bwd_bf16 if bf16 else lib.ct_trunk_bwd_f32
        n_blocks = kernels._trunk_bwd_blocks(n, smem, tile, idx)
        part = torch.empty((n_blocks, nw + nb), device=dev)
        res = torch.empty(nw + nb, device=dev)
        ptrs = (x.data_ptr(), wflat.data_ptr(), bflat.data_ptr(),
                dys[0].data_ptr(), dys[1].data_ptr() if head else None,
                None, part.data_ptr(), res.data_ptr(), n, d, w, L,
                int(head), 0 if head else w)

        def run():
            if general:
                err = lib.ct_trunk_bwd(*ptrs, int(bf16), tile, n_blocks,
                                       LEAK, stream)
            else:
                err = fn(*ptrs, tile, n_blocks, LEAK, stream)
            assert err == 0, (label, general, tile, err)
            return res
        per_sm = kernels.SMEM_PER_SM // (smem + 1024)
        return run, smem, n_blocks, per_sm * tile // 32

    tiles = (kernels.TRUNK_BWD_BF16_TILES if bf16
             else kernels.TRUNK_BWD_F32_TILES)
    tiles = [t for t in tiles
             if smem_of(d, w, L, head, t) <= kernels.MAX_SMEM_PER_BLOCK]
    general_tile = kernels.trunk_bwd_tile(d, w, L, head)
    name = "bf16 kernel" if bf16 else "f32 kernel"
    cases = {}
    for case, general, tile in ([(f"{name}, tile {t}", False, t)
                                 for t in tiles]
                                + [(f"trunk.cu backward, tile "
                                    f"{general_tile}", True, general_tile)]):
        run, smem, n_blocks, warps = launcher(general, tile)
        got = run().clone()
        again = run().clone()
        err = (got - want).abs().max().item()
        cases[case] = dict(
            max_abs_err=err, ok=err <= 1e-4 * gscale,
            max_abs_err_db=(got[nw:] - want[nw:]).abs().max().item(),
            bitwise_repeatable=torch.equal(got, again),
            device_ms=cs.device_ms(torch, run),
            ms=cs.time_ms(torch, run, reps=10), smem=smem,
            blocks=n_blocks, warps_per_sm=warps)
    F = d * w + (L - 1) * w * w + (2 * w if head else 0)
    n_out = n * (2 if head else w)
    b_ms, b_by = cs.bound(2.0 * n * (3 * F - d * w),
                          4.0 * (n * d + n_out + 2 * (F + nb)),
                          peaks[bf16], peaks["bytes"])
    print(json.dumps(dict(shape=label, bf16=bf16, n=n, d_in=d, width=w,
                          n_layers=L, head=head, route=route,
                          route_tile=rtile, tolerance=1e-4 * gscale,
                          bound_ms=b_ms, bound_by=b_by, cases=cases)),
          flush=True)


def k3_rows(lib, stream, gen, peaks, n=1_000_000):
    """K3 for n normals, at offset 3n (chip_smoke's kernel row) and at an
    unaligned offset: words bitwise and normals within chip_smoke's 2e-5 of
    the plain version; device and CUDA-event time beside torch.randn."""
    dev = torch.device("cuda", 0)
    seed = 0x1234567890ABCDEF
    out = torch.empty(n, device=dev)
    bits = torch.empty((n, 2), dtype=torch.int32, device=dev)
    rows = {}
    for offset in (3 * n, 3 * n + 1):
        def run(with_bits=False):
            err = lib.ct_philox_normal(
                out.data_ptr(), bits.data_ptr() if with_bits else None, n,
                seed & 0xFFFFFFFF, seed >> 32, offset, stream)
            assert err == 0, err
            return out
        run(True)
        e_p, bits_p = plain_prng_normal(n, seed, offset, dev, with_bits=True)
        rows[offset] = dict(
            words_bitwise=torch.equal(bits, bits_p),
            max_abs_err=(out - e_p).abs().max().item(),
            device_ms=cs.device_ms(torch, run), ms=cs.time_ms(torch, run))
    b_ms, b_by = cs.bound(0.0, 4.0 * n, peaks[False], peaks["bytes"])
    print("k3: " + json.dumps(dict(
        n=n, offsets=rows, bound_ms=b_ms, bound_by=b_by,
        library_device_ms=cs.device_ms(torch, lambda: torch.randn(
            n, generator=gen, device=dev)),
        library_ms=cs.time_ms(torch, lambda: torch.randn(
            n, generator=gen, device=dev)))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", action="append",
                    choices=("f32", "bf16", "k3", "ablate"),
                    help="what to run (repeatable; default f32, bf16 and "
                    "k3; ablate: the bf16 kernel's ablations)")
    parts = ap.parse_args().part or ["f32", "bf16", "k3"]
    if not torch.cuda.is_available():
        print("trunk_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, objs = build()
    print("sass: " + json.dumps(sass_counts(objs)), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = cs.peaks(name)
    peaks = {False: peak_flops, True: cs.bf16_peak(name), "bytes": peak_bw}
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    L = cs.N_LAYERS
    for label, n, d, w, head in SHAPES:
        for h_ in (True, False):
            assert (lib.ct_trunk_bwd_f32_smem(d, w, L, int(h_), 32)
                    == kernels.trunk_bwd_f32_smem(d, w, L, h_, 32))
            assert (lib.ct_trunk_bwd_bf16_smem(d, w, L, int(h_), 32)
                    == kernels.trunk_bwd_bf16_smem(d, w, L, h_, 32))
    if "k3" in parts:
        k3_rows(lib, stream, gen, peaks)
    if "ablate" in parts:
        ablate(lib, stream, gen)
    for bf16 in [p == "bf16" for p in ("bf16", "f32") if p in parts]:
        for label, n, d, w, head in SHAPES:
            shape_cases(lib, stream, gen, label, n, d, w, head, bf16, peaks)
            torch.cuda.empty_cache()
    if "f32" in parts:
        depth_sweep(lib, stream, gen)
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
