#!/usr/bin/env python3
"""The card's idle time in one benchmark cell's traced chunk, put down to
the training loop's spans (careless_tpu_torch/utils/spans.py).

    python3 tools/idle_by_span.py --workload <cell> --seed <n> [--seconds 3]

Runs `portbench.run` with --trace 1 as the benchmark runs a cell (its
result line ends standard output) and keeps the traced chunk's
torch.profiler session. From that session's events it then prints two
lines on standard error:

    idle by span: <span> <s> s (<share> %), ...; total <s> s
    spans a step: <span> <ms>, ...

The first puts every gap between the device's records down to the
innermost careless.* range on the host at the gap's middle ("outside any
span" where none runs), so its seconds add up to the chunk's idle
seconds; the second is each span's median ms a step from the profiler's
own ranges, to set beside the readers' (`host_ms_per_step`,
`elbo_host_ms`, ...), which read the program's record. Both from
portbench/spans.py.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def traced(argv, **kwargs):
    """(portbench.run.main(argv + --trace 1, **kwargs)'s exit code, the
    idle seconds by span, each span's median ms a step) of the run's last
    torch.profiler session; ([], {}) without one."""
    import torch.profiler
    from torch.autograd import DeviceType

    from portbench import run, spans

    sessions = []
    plain = torch.profiler.profile

    class Kept(plain):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            sessions.append(self)
            return out
    torch.profiler.profile = Kept
    try:
        rc = run.main([*argv, "--trace", "1"], **kwargs)
    finally:
        torch.profiler.profile = plain
    if not sessions:
        return rc, [], {}
    events = sessions[-1].events()
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    ranges = spans.event_spans(events)
    return (rc, spans.idle_by_span(ranges, device),
            spans.per_step_ms(spans.last_chunk(ranges)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import spans
    rc, idle, per_step = traced(["--workload", args.workload, "--seed",
                                 str(args.seed), "--seconds",
                                 str(args.seconds)])
    print(spans.idle_line(idle), file=sys.stderr)
    print("spans a step: " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in sorted(per_step.items())),
        file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
