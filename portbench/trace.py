"""Reading the profiler's trace of a window of merge steps.

`window_device_times` is the port's smoke-script arithmetic, copied: the
profiler drops some kernel records of a window, so each kernel's time is
its mean over the records kept times the launches they stand for (a port
kernel's launches by its counter, any other kernel's records rounded to a
whole number a step). One stream runs every kernel, so the device's busy
time is the sum of those times. The idle gaps are the spaces between the
device intervals the trace kept, each labelled by the innermost host
operation that was running at its middle.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def whole_launches(count: int, calls: int) -> int:
    """count rounded to a multiple of calls (0 for fewer than calls / 2)."""
    return calls * round(count / calls)


def window_device_times(events, launched: Dict[str, int], steps: int,
                        profiled_kernels):
    """(rows of (ms per step, launches per step, kernel), the launches each
    kernel's records stand for, whether every port kernel that launched
    left a record). `events` are the window's device entries of
    key_averages() (key, count, self_device_time_total in us); `launched`
    the port's launch counters over the window; `profiled_kernels` the
    port's (kernel symbols, counter names) groups."""
    stands_for, complete = {}, True
    for symbols, names in profiled_kernels:
        mine = [e for e in events if any(s in e.key for s in symbols)]
        want = sum(launched.get(k, 0) for k in names)
        kept = sum(e.count for e in mine)
        complete &= kept > 0 or want == 0
        for e in mine:
            stands_for[e.key] = e.count * want / kept
    for e in events:
        if e.key not in stands_for:
            stands_for[e.key] = max(e.count, whole_launches(e.count, steps))
    rows = sorted(((e.self_device_time_total / e.count * stands_for[e.key]
                    / 1e3 / steps, stands_for[e.key] / steps, e.key)
                   for e in events if stands_for[e.key]), reverse=True)
    return rows, stands_for, complete


def idle_gaps(device: List[Tuple[float, float]]) -> np.ndarray:
    """(start, end) in us of every interval between the device intervals,
    as an (n, 2) array."""
    if not device:
        return np.zeros((0, 2))
    iv = np.asarray(sorted(device), dtype=np.float64)
    reach = np.maximum.accumulate(iv[:, 1])
    gaps = np.stack([reach[:-1], iv[1:, 0]], axis=1)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def label_gaps(gaps: np.ndarray, host: List[Tuple[float, float, str]],
               top: int = 10) -> List[list]:
    """The `top` longest gaps as [label, seconds]: the innermost host
    operation running at the gap's middle ("idle, host outside any
    operation" where none was)."""
    out = []
    if not len(gaps):
        return out
    starts = np.asarray([h[0] for h in host], np.float64)
    ends = np.asarray([h[1] for h in host], np.float64)
    for lo, hi in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:top]]:
        mid = 0.5 * (lo + hi)
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("idle, host outside any operation" if not len(cover) else
                host[cover[np.argmin(ends[cover] - starts[cover])]][2])
        out.append([name, (hi - lo) / 1e6])
    return out


def group_seconds(traced: dict, counters) -> float:
    """Device seconds over the traced window of the port kernels whose
    launch counters are among `counters`."""
    symbols = [s for syms, names in traced["groups"]
               if set(names) & set(counters) for s in syms]
    return sum(ms for ms, _, key in traced["rows"]
               if any(s in key for s in symbols)) * traced["steps"] / 1e3


def roofline(traced, counters, group: str):
    """The kernels' share of their roofline in %: the sum of their
    launches' bounds over their device time; None where the trace lacks
    a port kernel's records or the kernels did not run."""
    if traced is None or not traced["complete"]:
        return None
    spent = group_seconds(traced, counters)
    if spent <= 0 or not traced["bounds"].get(group):
        return None
    return 100.0 * traced["bounds"][group] / spent
