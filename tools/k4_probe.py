#!/usr/bin/env python3
"""csrc/fused_ll.cu (K4-fwd and K4-bwd) on the card, without building the
rest of the port's kernels.

    python3 tools/k4_probe.py [--old DIR] [--build-only]

Compiles csrc/fused_ll.cu alone (tools/probe_build.py, the port's nvcc
flags) into build/k4_probe/new/ (with --old DIR, DIR's csrc/fused_ll.cu too,
into .../old/; DIR is the root of another checkout, e.g. a `git archive` of
the parent commit unpacked under build/), and prints ptxas' register and
spill lines of each build's kernels and the SASS instruction counts of the
normal kind's forward (build/k4_probe/<tag>/fused_ll.sass holds the whole).

Then one JSON line per kind, normal (slice (a)) and studentt_ev11 (slice
(b)), at chip_smoke's K4 inputs (1M observations, sample 1 of a step, so
offset 1M), and one at offset 1M + 1 (no 16-byte loads): each build's
forward within 1e-5 of the sum of |ll| of the plain version, its backward's
per-observation gradients bit for bit the other build's and its Ev11 sums
within 1e-5 of plain's relative, and device milliseconds per call
(chip_smoke.device_ms, the profiler's kernel time, every kernel a call
launches summed) of both directions beside chip_smoke's bounds; builds take
turns (old, new, then new, old at the next kind). Then the new forward at
other grids than the launcher's (1, 2, 4 and 8 blocks a SM) at the normal
kind, the SM clock under load, and the new build's tickets (the device
counters of its last-block sums) before its first launch and after its
last. Exits 1 if a build disagrees with plain, the backwards disagree with
each other, or a ticket is left off 0.
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
from careless_tpu_torch.ops.fused_elbo import (  # noqa: E402
    plain_fused_likelihood_grads, plain_fused_likelihood_sum,
    plain_prng_normal, pointwise_grads, pointwise_ll, studentt_log_norm)
from tools import probe_build  # noqa: E402

OUT = ROOT / "build" / "k4_probe"
KERNELS = {"fused_ll_fwd_kernelILi0ELb0E": "forward, normal",
           "fused_ll_fwd_kernelILi4ELb0E": "forward, studentt_ev11",
           "fused_ll_bwd_kernelILi0ELb0E": "backward, normal",
           "fused_ll_bwd_kernelILi4ELb0E": "backward, studentt_ev11",
           "reduce_parts": "reduce_parts"}
KINDS = probe_build.COUNTED + ("FADD", "FMUL", "MUFU", "IMAD", "SHFL",
                               "ATOM", "RED", "MEMBAR")


class Build:
    """One build's C entry points. The new design's forward takes its grid
    (n_parts) and has ct_fused_ll_bwd_parts; the earlier one sizes its own
    grid (a block per 256 observations) and reduces in a second launch."""

    def __init__(self, tag, lib):
        self.tag, self.lib = tag, lib
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        U32, U64 = ctypes.c_uint32, ctypes.c_uint64
        self.new = hasattr(lib, "ct_fused_ll_bwd_parts")
        lib.ct_fused_ll_fwd.argtypes = [P] * 11 + [I] * (3 if self.new
                                                         else 2) \
            + [F, F, U32, U32, U64, P]
        lib.ct_fused_ll_bwd.argtypes = [P] * 16 + [I, I, F, F, U32, U32,
                                                   U64, P]
        lib.ct_fused_ll_parts.argtypes = [I, I] if self.new else [I]
        if self.new:
            lib.ct_fused_ll_bwd_parts.argtypes = [I]

    def fwd_parts(self, n, per_sm=None):
        if not self.new:
            return max(1, self.lib.ct_fused_ll_parts(n))
        if per_sm is None:
            return self.lib.ct_fused_ll_parts(n, kernels._sm_count(0))
        return max(1, min(-(-(-(-n // 4) + 1) // 256),
                          per_sm * kernels._sm_count(0)))

    def bwd_parts(self, n):
        return (self.lib.ct_fused_ll_bwd_parts(n) if self.new
                else max(1, self.lib.ct_fused_ll_parts(n)))

    def fwd(self, args, ev, n, kind, cfg, stream, per_sm=None):
        parts = self.fwd_parts(n, per_sm)
        part = torch.empty(parts, device="cuda")
        out = torch.empty((), device="cuda")
        k = kernels.FUSED_KINDS.index(kind)
        seed = cfg["seed"]
        head = [*(x.data_ptr() for x in args), None, None, ev.data_ptr(),
                part.data_ptr(), out.data_ptr(), n]
        tail = [k, cfg["dof"], cfg["t_const"], seed & 0xFFFFFFFF, seed >> 32,
                cfg["offset"], stream]
        call = head + ([parts] if self.new else []) + tail

        def run():
            err = self.lib.ct_fused_ll_fwd(*call)
            assert err == 0, (self.tag, "forward", err)
            return out
        run.scratch = part   # held while the closure lives: the kernel writes it
        return run

    def bwd(self, args, ev, ct, n, kind, cfg, stream):
        grads = torch.empty((4, n), device="cuda")
        part = torch.empty((self.bwd_parts(n), 3), device="cuda")
        dev = torch.empty(3, device="cuda")
        k = kernels.FUSED_KINDS.index(kind)
        seed = cfg["seed"]
        g = grads.data_ptr()
        call = [*(x.data_ptr() for x in args), None, None, ev.data_ptr(),
                ct.data_ptr(), g, g + 4 * n, g + 8 * n, g + 12 * n,
                part.data_ptr(), dev.data_ptr(), n, k, cfg["dof"],
                cfg["t_const"], seed & 0xFFFFFFFF, seed >> 32, cfg["offset"],
                stream]

        def run():
            err = self.lib.ct_fused_ll_bwd(*call)
            assert err == 0, (self.tag, "backward", err)
            return grads, dev
        run.scratch = part
        return run


def compile_all(jobs):
    """Each build's fused_ll.cu compiled alone into OUT/tag/, all nvcc
    processes at once; returns {tag: (Build, object, ptxas log)}."""
    objs = {tag: OUT / tag / "fused_ll.o" for tag in jobs}
    logs = probe_build.compile_objects(
        {obj: (jobs[tag] / "fused_ll.cu", jobs[tag])
         for tag, obj in objs.items()})
    built = {}
    for tag, obj in objs.items():
        (OUT / tag / "build.log").write_text(logs[obj])
        built[tag] = (Build(tag, probe_build.link([obj],
                                                  OUT / tag / "probe.so")),
                      obj, logs[obj])
    return built


def report(built):
    for tag, (_, obj, log) in built.items():
        for label, line in probe_build.ptxas_lines(log, KERNELS):
            print(f"ptxas, {tag} {label}: {line}", flush=True)
        counts = probe_build.sass_counts(
            obj, {k: v for k, v in KERNELS.items() if "fwd" in k},
            OUT / tag / "fused_ll.sass", kinds=KINDS, loops=4)
        print(f"sass, {tag}: " + json.dumps(
            {k: v["whole"] for k, v in counts.items()}), flush=True)


def launches_per_call(run):
    """Kernel launches the profiler records for one call of run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 10


def kind_line(builds, stream, args, kind, dof, offset, peaks, eps_plain):
    n = args[0].shape[0]
    seed = 0x0FEDCBA987654321
    cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
               t_const=studentt_log_norm(dof) if dof else 0.0)
    ev = torch.tensor([1.3, 0.2, 0.7], device="cuda")
    ct = torch.tensor(0.75, device="cuda")
    want = plain_fused_likelihood_sum(*args, None, ev, eps_plain, kind=kind,
                                      dof=dof)
    loc, scale, a, f, iobs, sig = args
    ipred = (a * loc + a.abs() * scale * eps_plain) * f * f
    l1 = pointwise_ll(kind, dof, ev, iobs, sig, ipred).abs().sum().item()
    ref = plain_fused_likelihood_grads(*args, None, ev, eps_plain, ct,
                                       kind=kind, dof=dof)
    ev_l1 = None
    if kind.endswith("_ev11"):
        _, terms = pointwise_grads(kind, dof, ev, iobs, sig, ipred)
        ev_l1 = [ct.item() * t.abs().sum().item() for t in terms]
    res, grads = {}, {}
    for bld in builds:
        fwd = bld.fwd(args, ev, n, kind, cfg, stream)
        bwd = bld.bwd(args, ev, ct, n, kind, cfg, stream)
        got = fwd().item()
        g, d = (t.clone() for t in bwd())
        grads[bld.tag] = g
        repeats = got == fwd().item()
        ok = abs(got - want.item()) <= 1e-5 * l1 and repeats
        extra = {}
        if ev_l1 is not None:
            ev_err = [abs(d[k].item() - ref[4][k].item()) for k in range(3)]
            d_again = bwd()[1].clone()
            ok &= all(e <= 1e-5 * t for e, t in zip(ev_err, ev_l1)) \
                and torch.equal(d, d_again)
            extra = dict(ev_err=ev_err, ev_tolerance=[1e-5 * t for t in ev_l1],
                         ev_got=d.tolist(), ev_plain=ref[4].tolist(),
                         ev_repeats=torch.equal(d, d_again))
        res[bld.tag] = dict(
            fwd_err=abs(got - want.item()), fwd_tolerance=1e-5 * l1,
            fwd_repeats=repeats, ok=ok, **extra,
            fwd_device_ms=cs.device_ms(torch, fwd),
            fwd_ms=cs.time_ms(torch, fwd),
            bwd_device_ms=cs.device_ms(torch, bwd),
            bwd_ms=cs.time_ms(torch, bwd),
            fwd_launches=launches_per_call(fwd),
            fwd_parts=bld.fwd_parts(n))
    tags = list(grads)
    res["bwd_bit_for_bit_equal"] = all(torch.equal(grads[tags[0]], grads[t])
                                       for t in tags[1:])
    fwd_b = cs.bound(cs.K4_OPS_PER_OBS * n, 4.0 * 6 * n, *peaks)
    bwd_b = cs.bound(cs.K4_OPS_PER_OBS * n, 4.0 * 10 * n, *peaks)
    print(json.dumps(dict(kind=kind, n=n, offset=offset,
                          fwd_bound_ms=fwd_b[0], bwd_bound_ms=bwd_b[0],
                          bound_by=fwd_b[1], builds=res)), flush=True)
    return all(r["ok"] for r in res.values() if isinstance(r, dict)) \
        and res["bwd_bit_for_bit_equal"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help="root of another checkout whose csrc/fused_ll.cu "
                    "is probed beside this one")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the registers and SASS counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 2
    jobs = {"new": _build.CSRC}
    if args.old:
        jobs["old"] = args.old.resolve() / "careless_tpu_torch" / "csrc"
    built = compile_all(jobs)
    report(built)
    new = built["new"][0]
    tickets = (ctypes.c_uint32 * 2)()
    new.lib.ct_fused_ll_tickets.argtypes = [ctypes.c_void_p]
    new.lib.ct_fused_ll_tickets(tickets)
    print("new build's tickets before its first launch (their initial "
          f"contents): {list(tickets)}", flush=True)
    print(cs.card_line(), flush=True)
    if args.build_only:
        return 0
    peaks = cs.peaks(torch.cuda.get_device_name(0))
    stream = torch.cuda.current_stream(0).cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = cs.N_OBS
    k4 = cs.k4_inputs(torch, gen, n, torch.device("cuda"))
    builds = [built[t][0] for t in ("old", "new") if t in built]
    ok = True
    for offset in (n, n + 1):
        eps = plain_prng_normal(n, 0x0FEDCBA987654321, offset, "cuda")
        for kind, dof in (("normal", 0.0), ("studentt_ev11", 4.0)):
            ok &= kind_line(builds, stream, k4, kind, dof, offset, peaks,
                            eps)
            builds.reverse()
    ev = torch.tensor([1.3, 0.2, 0.7], device="cuda")
    cfg = dict(kind="normal", dof=0.0, seed=0x0FEDCBA987654321, offset=n,
               t_const=0.0)
    grids = {}
    for per_sm in (1, 2, 4, 8):
        run = new.fwd(k4, ev, n, "normal", cfg, stream, per_sm=per_sm)
        grids[per_sm] = dict(parts=new.fwd_parts(n, per_sm),
                             device_ms=cs.device_ms(torch, run),
                             value=run().item())
    print("new forward, normal, by blocks a SM: " + json.dumps(grids),
          flush=True)
    run = new.fwd(k4, ev, n, "normal", cfg, stream)
    for _ in range(20_000):
        run()
    print("clocks under load: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    torch.cuda.synchronize()
    new.lib.ct_fused_ll_tickets(tickets)
    print(f"new build's tickets after its launches: {list(tickets)}",
          flush=True)
    ok &= list(tickets) == [0, 0]
    print("profiler: kernel records captured of the launches timed: "
          + json.dumps(cs.CAPTURED))
    print(cs.card_line())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
