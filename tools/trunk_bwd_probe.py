#!/usr/bin/env python3
"""The f32 K1-bwd (csrc/trunk_bwd.cu) beside csrc/trunk.cu's backward, on the
card, without building the rest of the port's kernels.

    python3 tools/trunk_bwd_probe.py

Compiles csrc/trunk_bwd.cu and csrc/trunk.cu alone, with the port's nvcc
flags (kernels/_build.py NVCC_FLAGS), into build/trunk_bwd_probe/ (a
minute of nvcc), prints ptxas' register and spill lines of the f32 kernel
at width 10 and the counts of its shared-memory instructions by width
(cuobjdump -sass: LDS.128 are the 16-byte loads), and then, one JSON line
per shape: at 1M observations of d = w = 10 over 20 layers (head and trunk
only), 10M (head), and 20 layers of width 28 over d_in 28 and width 32
over d_in 128 at 100k, the f32 kernel at each block size of
kernels.TRUNK_BWD_F32_TILES that fits (its route's first) and
csrc/trunk.cu's backward with bf16 off, each held
against the plain version (autograd through plain_trunk_head or
plain_trunk) at chip_smoke.trunk_rows' tolerance, 1e-4 of the gradients'
largest entry, and against itself bit for bit; with device milliseconds
per call (chip_smoke.device_ms, the profiler's kernel time), CUDA-event
milliseconds and the operation bound chip_smoke's rows use; last, the f32
kernel at 1M (head, width 10) over 20, 10 and 5 layers, with the warps
per SM its shared memory allows and its device microseconds per layer,
which shows what residency is worth (the stash of activations grows with
depth). The whole log of the build goes to build/trunk_bwd_probe/build.log.
"""
import ctypes
import json
import re
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

OUT = ROOT / "build" / "trunk_bwd_probe"
LOG = OUT / "build.log"
LEAK = 0.01
# (label, observations, d_in, width, head)
SHAPES = (("1M head", 1_000_000, 10, 10, True),
          ("1M trunk only", 1_000_000, 10, 10, False),
          ("10M head", 10_000_000, 10, 10, True),
          ("width 28, d_in 28", 100_000, 28, 28, True),
          ("width 32, d_in 128", 100_000, 128, 32, True))


def build():
    """Both sources compiled at once, linked into one library; returns it
    and the f32 object's path (for cuobjdump)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for name in ("trunk_bwd.cu", "trunk.cu"):
        obj = OUT / (Path(name).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
             str(_build.CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    for proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode:
            raise RuntimeError(out)
    so = OUT / "probe.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(so), *map(str, objs)], check=True)
    LOG.write_text("\n".join(log))
    lines = log[0].splitlines()
    for i, line in enumerate(lines):
        if "trunk_bwd_f32_kernelILi10E" in line and "Compiling" in line:
            print("ptxas, width 10: " + " | ".join(
                s.strip() for s in lines[i:i + 4]), flush=True)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ct_trunk_bwd_f32.argtypes = [P] * 8 + [I] * 8 + [F, P]
    lib.ct_trunk_bwd.argtypes = [P] * 8 + [I] * 9 + [F, P]
    lib.ct_trunk_bwd_f32_smem.argtypes = [I] * 5
    lib.ct_trunk_bwd_f32_smem.restype = ctypes.c_size_t
    return lib, objs


def sass_counts(objs):
    """Shared-memory and FMA instructions by kernel and width, from the SASS
    of both objects: the f32 kernel at widths 10, 28 and 32 and
    csrc/trunk.cu's backward at width 10."""
    want = {"trunk_bwd_f32_kernelILi10E": "f32 kernel, width 10",
            "trunk_bwd_f32_kernelILi28E": "f32 kernel, width 28",
            "trunk_bwd_f32_kernelILi32E": "f32 kernel, width 32",
            "trunk_bwd_kernelILi10E": "trunk.cu backward, width 10"}
    counts = {}
    for obj in objs:
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(obj)], capture_output=True, text=True,
                              check=True).stdout
        current = None
        for line in sass.splitlines():
            if "Function :" in line:
                current = next((v for k, v in want.items() if k in line),
                               None)
                if current:
                    counts[current] = {}
                continue
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)",
                          line)
            if current and m:
                op = m.group(1)
                if op.startswith(("LDS", "STS", "FFMA", "BAR")):
                    counts[current][op] = counts[current].get(op, 0) + 1
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


def main():
    if not torch.cuda.is_available():
        print("trunk_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, objs = build()
    print("sass: " + json.dumps(sass_counts(objs)), flush=True)
    dev = torch.device("cuda", 0)
    idx = 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    peak_flops, peak_bw = cs.peaks(torch.cuda.get_device_name(0))
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    L = cs.N_LAYERS

    for label, n, d, w, head in SHAPES:
        for h_ in (True, False):
            assert (lib.ct_trunk_bwd_f32_smem(d, w, L, int(h_), 32)
                    == kernels.trunk_bwd_f32_smem(d, w, L, h_, 32))
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
        ys = (plain_trunk_head(x, lay, o, LEAK) if head
              else (plain_trunk(x, lay, LEAK),))
        want = torch.cat(torch.autograd.grad(
            sum((y * c).sum() for y, c in zip(ys, dys)), [wl, bl]))
        del ys, lay, o, wl, bl
        gscale = want.abs().max().item()

        def launcher(f32, tile):
            smem = (kernels.trunk_bwd_f32_smem if f32 else kernels.trunk_smem)(
                d, w, L, head, tile)
            n_blocks = kernels._trunk_bwd_blocks(n, smem, tile, idx)
            part = torch.empty((n_blocks, nw + nb), device=dev)
            res = torch.empty(nw + nb, device=dev)
            ptrs = (x.data_ptr(), wflat.data_ptr(), bflat.data_ptr(),
                    dys[0].data_ptr(), dys[1].data_ptr() if head else None,
                    None, part.data_ptr(), res.data_ptr(), n, d, w, L,
                    int(head), 0 if head else w)

            def run():
                if f32:
                    err = lib.ct_trunk_bwd_f32(*ptrs, tile, n_blocks, LEAK,
                                               stream)
                else:
                    err = lib.ct_trunk_bwd(*ptrs, 0, tile, n_blocks, LEAK,
                                           stream)
                assert err == 0, (label, f32, tile, err)
                return res
            return run, smem, n_blocks

        route, rtile = kernels.trunk_bwd_route(d, w, L, head, False)
        cases = {}
        f32_tiles = [rtile] if route == kernels.TRUNK_BWD_F32 else []
        f32_tiles += [t for t in kernels.TRUNK_BWD_F32_TILES if t != rtile and
                      kernels.trunk_bwd_f32_smem(d, w, L, head, t)
                      <= kernels.MAX_SMEM_PER_BLOCK]
        general_tile = kernels.trunk_bwd_tile(d, w, L, head)
        for name, f32, tile in ([(f"f32 kernel, tile {t}", True, t)
                                 for t in f32_tiles]
                                + [(f"trunk.cu backward, tile {general_tile}",
                                    False, general_tile)]):
            run, smem, n_blocks = launcher(f32, tile)
            got = run().clone()
            again = run().clone()
            err = (got - want).abs().max().item()
            cases[name] = dict(
                max_abs_err=err, ok=err <= 1e-4 * gscale,
                bitwise_repeatable=torch.equal(got, again),
                device_ms=cs.device_ms(torch, run),
                ms=cs.time_ms(torch, run, reps=10), smem=smem,
                blocks=n_blocks)
        F = d * w + (L - 1) * w * w + (2 * w if head else 0)
        n_out = n * (2 if head else w)
        b_ms, b_by = cs.bound(2.0 * n * (3 * F - d * w),
                              4.0 * (n * d + n_out + 2 * (F + nb)),
                              peak_flops, peak_bw)
        print(json.dumps(dict(shape=label, n=n, d_in=d, width=w, n_layers=L,
                              head=head, route=route, route_tile=rtile,
                              tolerance=1e-4 * gscale, bound_ms=b_ms,
                              bound_by=b_by, cases=cases)), flush=True)
        del x, dys, want
        torch.cuda.empty_cache()
    depth_sweep(lib, stream, gen)
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
