"""Reading the port's training-loop spans (careless_tpu_torch/utils/spans.py)
over a traced chunk.

A span here is (name, start, end) with times in microseconds on one
clock: the program's own record (RECORDED, the host's monotonic clock),
which the readers take, or the profiler's careless.* ranges
(prof.events(), the clock of its device records), which
tools/idle_by_span.py takes with the device's records. The chunk is the last careless.chunk span; a step is a
careless.step span, and each span's time in a step is the sum of its
spans that lie inside the step's. `idle_by_span` puts each idle gap of
the device (trace.idle_gaps: the spaces between its intervals) down to
the innermost span running on the host at the gap's middle.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

from . import trace

PREFIX = "careless."
CHUNK, STEP = "careless.chunk", "careless.step"
OUTSIDE = "outside any span"

Span = Tuple[str, float, float]


def program_spans() -> List[Span]:
    """The program's record of its spans, oldest first; [] where the
    program keeps none."""
    try:
        from careless_tpu_torch.utils import spans
    except ImportError:
        return []
    return sorted(((s.name, s.start_ns / 1e3, s.end_ns / 1e3)
                   for s in getattr(spans, "RECORDED", ())),
                  key=lambda s: (s[1], -s[2]))


def event_spans(events) -> List[Span]:
    """The profiler's careless.* ranges on the host among `events`
    (prof.events()). On the card the profiler also draws each range over
    the device records it launched, as a user annotation of the device:
    those are left out."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events
                   if getattr(e, "is_user_annotation", False)
                   and e.device_type == DeviceType.CPU
                   and e.name.startswith(PREFIX)),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans: List[Span], lo: float, hi: float) -> List[Span]:
    return [s for s in spans if lo <= s[1] and s[2] <= hi]


def last_chunk(spans: List[Span]) -> List[Span]:
    """The spans of the last careless.chunk, itself included; [] without
    one."""
    chunks = [s for s in spans if s[0] == CHUNK]
    if not chunks:
        return []
    last = max(chunks, key=lambda s: s[1])
    return _inside(spans, last[1], last[2])


def per_step_ms(spans: List[Span]) -> Dict[str, float]:
    """Each span name's median over the careless.step spans of its time
    inside the step in ms (0 in a step without it); {} without a step."""
    steps = [s for s in spans if s[0] == STEP]
    if not steps:
        return {}
    sums: List[Dict[str, float]] = []
    for step in steps:
        got: Dict[str, float] = {}
        for name, lo, hi in _inside(spans, step[1], step[2]):
            got[name] = got.get(name, 0.0) + (hi - lo) / 1e3
        sums.append(got)
    names = {n for got in sums for n in got}
    return {n: statistics.median(got.get(n, 0.0) for got in sums)
            for n in names}


def innermost(spans: List[Span], t: float) -> Optional[str]:
    """The name of the shortest span running at time t, or None."""
    cover = [s for s in spans if s[1] <= t <= s[2]]
    return min(cover, key=lambda s: s[2] - s[1])[0] if cover else None


def idle_by_span(spans: List[Span], device: List[Tuple[float, float]]
                 ) -> List[Tuple[str, float]]:
    """[(span name or OUTSIDE, idle seconds)], largest first: every gap
    between the device intervals (us) summed by the innermost span at its
    middle. The seconds add up to the gaps' total."""
    out: Dict[str, float] = {}
    for lo, hi in trace.idle_gaps(device):
        name = innermost(spans, 0.5 * (lo + hi)) or OUTSIDE
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def idle_line(idle: List[Tuple[str, float]]) -> str:
    """'idle by span: <name> <s> s (<share> %), ...' over the total."""
    total = sum(s for _, s in idle)
    return "idle by span: " + ", ".join(
        f"{name} {s:.6f} s ({100 * s / total:.2f} %)" for name, s in idle
    ) + f"; total {total:.6f} s"


def step_ms(run, name: str) -> Optional[float]:
    """The median ms a step of span `name` over the traced chunk's steps,
    from the program's record; None without a traced chunk, a step in it,
    or the span."""
    if run.trace is None:
        return None
    return per_step_ms(last_chunk(program_spans())).get(name)

