#!/usr/bin/env python3
"""Host microseconds per call of K4's two launchers, from a given checkout.

    python3 tools/k4_launch_host_us.py [--root DIR] [--calls 300]

Imports careless_tpu_torch from DIR (default: this checkout), builds its
kernels there, and times kernels.fused_ll_fwd and kernels.fused_ll_bwd at
slice (a)'s shape (1M observations, kind normal, the in-kernel normals)
with chip_smoke.host_us, less an empty call's time, before any profiler
capture; prints the card and one JSON line. Run on two checkouts in turns
(A, B, B, A) in one command to compare their launch paths on one card.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("k4_launch_host_us: no CUDA device", file=sys.stderr)
        return 2
    from careless_tpu_torch import kernels
    assert Path(kernels.__file__).resolve().is_relative_to(root), \
        kernels.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = cs.N_OBS
    loc, scale, a, f, iobs, sig = cs.k4_inputs(torch, gen, n, dev)
    ev = torch.tensor([1.3, 0.2, 0.7], device=dev)
    ct = torch.tensor(0.75, device=dev)
    cfg = dict(kind="normal", dof=0.0, t_const=0.0, seed=7, offset=n)
    inputs = (loc, scale, a, f, iobs, sig, None, None, ev)
    kernels.fused_ll_fwd(*inputs, **cfg)   # builds the kernels
    times = cs.host_us(torch, {
        "empty call": lambda: None,
        "fused_ll_fwd": lambda: kernels.fused_ll_fwd(*inputs, **cfg),
        "fused_ll_bwd": lambda: kernels.fused_ll_bwd(*inputs, ct, **cfg)},
        args.calls)
    empty = times.pop("empty call")
    print(cs.card_line())
    print(json.dumps(dict(root=str(root), calls=args.calls, empty_us=empty,
                          **{k: v - empty for k, v in times.items()})),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
