#!/usr/bin/env python3
"""Design variants of the gathers K2 and K5, timed side by side on the card.

    python3 tools/gather_variants.py        (from the root of the repo)

Builds tools/gather_variants.cu and the port's csrc/gather.cu and
csrc/gather_stream.cu into libraries under build/ (a few seconds of nvcc)
and prints, one JSON line each:
  - host microseconds per call of the pieces of a gather launch (torch.empty
    in several forms, a ctypes call that returns at once, one that launches)
    beside index_select, in rounds that take them in turn (chip_smoke's
    host_us), before any profiler capture and again after one;
  - K2's device time (chip_smoke's device_ms: warm, and after an L2 flush)
    in the kept design (csrc/gather.cu: 4 ids per thread, evict-first
    hints on ids and output) beside the earlier K2 (variant 0), an evict-last
    L2 policy on the table (2), 8 ids per thread (3, 4) and evict-first /
    evict-last policies on both (5), and index_select: at the mono shapes
    (1M ids into 50k sorted, 2k unsorted), at the Laue step's image
    cotangent permute (10M), and at 10M random ids into tables of 1M, 2.5M
    and 10M entries (a table that fits in L2 beside the streams, and one
    that does not);
  - K5 at the Laue chain plan's backward permute: the kept kernel (bulk
    asynchronous window copy) beside the earlier one (synchronous
    staging), K2 on the same flat ids and index_select, twice in turn.
The Laue inputs are chip_smoke's, at 10M observations (about 30 s of host
set-up). Every result is checked bit for bit against index_select.
"""
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

VARIANTS = (0, 2, 3, 4, 5)   # tools/gather_variants.cu's kv_launch


def build():
    nvcc = "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xcompiler", "-fPIC", "-shared"]
    out = ROOT / "build" / "gather_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {out / "variants.so": [ROOT / "tools" / "gather_variants.cu"],
            out / "kept.so": [ROOT / "careless_tpu_torch" / "csrc" / name
                              for name in ("gather.cu", "gather_stream.cu")]}
    procs = [subprocess.Popen([nvcc, *flags, "-o", str(so),
                               *map(str, srcs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for so, srcs in jobs.items()]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    var, kept = (ctypes.CDLL(str(so)) for so in jobs)
    for fn, argtypes in ((var.kv_launch, [I, P, P, P, I, P]),
                         (var.k5_old_launch, [P, I64, P, P, P, I, I, I, P]),
                         (kept.ct_gather, [P, P, P, I, P]),
                         (kept.ct_gather_stream,
                          [P, I64, P, P, P, I, I, I, P])):
        fn.argtypes, fn.restype = argtypes, I
    return var, kept


def us(ms):
    """chip_smoke's device milliseconds in microseconds (None: the profiler
    kept dropping events)."""
    return None if ms is None else 1e3 * ms


def main():
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 2
    var, kept = build()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(cs.card_line(), flush=True)
    flush = cs.l2_flush(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def k2(v, table, ids):
        out = torch.empty(ids.numel(), device=dev)
        args = (table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                ids.numel(), stream)
        err = kept.ct_gather(*args) if v == "kept" else var.kv_launch(v, *args)
        assert err == 0, err
        return out

    def k2_case(label, table, ids):
        want = torch.index_select(table, 0, ids)
        fns = {str(v): (lambda v=v: k2(v, table, ids))
               for v in ("kept",) + VARIANTS}
        fns["index_select"] = lambda: torch.index_select(table, 0, ids)
        out = {}
        for name, fn in fns.items():
            assert torch.equal(fn(), want), (label, name)
            out[name] = [us(cs.device_ms(torch, fn)),
                         us(cs.device_ms(torch, fn, flush=flush))]
        print(f"K2 {label}, device us [warm, cold]: " + json.dumps(out),
              flush=True)

    n = 1_000_000
    table = torch.randn(50_000, generator=gen, device=dev)
    ids = torch.sort(torch.randint(0, 50_000, (n,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    out = torch.empty(n, device=dev)
    f32 = torch.float32
    ptrs = (table.data_ptr(), ids.data_ptr(), out.data_ptr())
    host = {
        "torch.empty(ids.shape, dtype, device)":
            lambda: torch.empty(ids.shape, dtype=f32, device=dev),
        "torch.empty(n, dtype, device)":
            lambda: torch.empty(n, dtype=f32, device=dev),
        "torch.empty_like(ids, dtype)": lambda: torch.empty_like(ids,
                                                                 dtype=f32),
        "ctypes call, n = 0 (no launch)": lambda: kept.ct_gather(*ptrs, 0,
                                                                 stream),
        "ctypes call that launches": lambda: kept.ct_gather(*ptrs, n, stream),
        "index_select": lambda: torch.index_select(table, 0, ids),
    }
    print("host us, before any profiler capture: "
          + json.dumps(cs.host_us(torch, host)), flush=True)
    cs.device_ms(torch, lambda: torch.index_select(table, 0, ids))
    print("host us, after one: " + json.dumps(cs.host_us(torch, host)),
          flush=True)

    k2_case("z_f (1M sorted ids, 50k table)", table, ids)
    k2_case("image (1M ids, 2k table)",
            torch.randn(2_000, generator=gen, device=dev),
            torch.randint(0, 2_000, (n,), generator=gen, device=dev,
                          dtype=torch.int32))
    del table, ids, out

    t0 = time.perf_counter()
    _, _, _, inputs, _ = cs.model_on(None, 0, cs.LAUE_OBS, cs.LAUE_REFL,
                                     cs.LAUE_IMAGES, cs.D_META, cs.N_LAYERS,
                                     laue=True)
    print(f"Laue set-up {time.perf_counter() - t0:.1f} s", flush=True)
    N = inputs.n_obs
    x = torch.randn(N, generator=gen, device=dev)
    k2_case(f"Laue image cotangent permute ({N})", x, inputs.plans.image.perm)
    for size in (1_000_000, 2_500_000, N):
        k2_case(f"{N} random ids into {size}",
                torch.randn(size, generator=gen, device=dev),
                torch.randint(0, size, (N,), generator=gen, device=dev,
                              dtype=torch.int32))

    pp = inputs.plans.refl.inner.perm_plan
    flat = pp.ids2d.reshape(-1)
    want = torch.index_select(x, 0, flat)

    def k5(fn):
        out = torch.empty(flat.numel(), device=dev)
        err = fn(x.data_ptr(), N, pp.ids2d.data_ptr(), pp.bases.data_ptr(),
                 out.data_ptr(), pp.bases.shape[0], pp.block_rows * 128,
                 pp.window, stream)
        assert err == 0, err
        return out

    fns = {"K5 kept": lambda: k5(kept.ct_gather_stream),
           "K5, earlier design": lambda: k5(var.k5_old_launch),
           "K2 kept, flat ids": lambda: k2("kept", x, flat),
           "index_select": lambda: torch.index_select(x, 0, flat)}
    res = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            assert torch.equal(fn(), want), name
            res[name].append([us(cs.device_ms(torch, fn)),
                              us(cs.device_ms(torch, fn, flush=flush))])
    print(f"K5 at the chain permute (window {pp.window}, {pp.bases.shape[0]} "
          "tiles), device us [warm, cold] twice in turn: " + json.dumps(res),
          flush=True)
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
