"""Run-aligned harmonic convolution: the Laue scatter-add without gathers.

Counterpart of careless_tpu/ops/conv_runs.py. On the training layout
harmonic groups are short contiguous runs of rows, so the convolution of
per-observation predictions into group buckets has a closed form,

    conv_start[o] = sum_{k < run_len[o]} ipred[o + k]   (max_run shifted adds)

scored at each run's start row against the group's intensity broadcast to
that row, plus a static tail for the group-table rows no group id hits
(scored at conv == 0, as the group layout scores them; for the Ev11
likelihoods that tail carries a gradient). conv_start_sums is plain tensor
code, not a kernel; autograd takes its transpose.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# beyond this many observations per group the shifted adds lose to the
# segment sum; real Laue harmonic groups hold <= ~6
MAX_RUN = 16


@dataclass(frozen=True, eq=False)
class ConvRunPlan:
    """Static run layout (all (N,) tensors on the inputs' device).

    start_ll_mask: f32, 1 at the first row of each real group, else 0
    run_len:       int32, group size at start rows, else 0
    iobs_row, sig_row: f32, the group's packed intensity and uncertainty
                   broadcast to its rows
    tail_mask:     f32, group-table rows no group id hits (and not masked
                   out), scored at conv == 0
    max_run:       the largest group size (number of shifted adds)
    """

    start_ll_mask: torch.Tensor
    run_len: torch.Tensor
    iobs_row: torch.Tensor
    sig_row: torch.Tensor
    tail_mask: torch.Tensor
    max_run: int


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def make_conv_run_plan(harmonic_id, intensities, uncertainties,
                       mask=None) -> Optional[ConvRunPlan]:
    """Build the plan on the host; None when the layout does not qualify
    (unsorted group ids, or a group longer than MAX_RUN). The tensors land
    on harmonic_id's device (the CPU for numpy input). mask, when given,
    is the group-table row mask: a group is real iff mask[group_id] == 1."""
    device = (harmonic_id.device if isinstance(harmonic_id, torch.Tensor)
              else torch.device("cpu"))
    hid = _host(harmonic_id)
    n = len(hid)
    if n == 0 or not bool(np.all(hid[1:] >= hid[:-1])):
        return None
    iobs = _host(intensities).astype(np.float32)
    sig = _host(uncertainties).astype(np.float32)
    if iobs.shape[0] != n or sig.shape[0] != n:
        return None  # the group table has the rows' length (packed layout)

    is_start = np.ones(n, bool)
    is_start[1:] = hid[1:] != hid[:-1]
    starts = np.flatnonzero(is_start)
    run_len_at_start = np.diff(np.append(starts, n)).astype(np.int32)
    max_run = int(run_len_at_start.max())
    if max_run > MAX_RUN:
        return None

    run_len = np.zeros(n, np.int32)
    run_len[starts] = run_len_at_start
    group_mask = (np.ones(n, np.float32) if mask is None
                  else _host(mask).astype(np.float32))
    start_ll_mask = np.zeros(n, np.float32)
    start_ll_mask[starts] = group_mask[hid[starts]]
    hit = np.zeros(n, bool)
    hit[hid] = True
    tail_mask = (group_mask * ~hit).astype(np.float32)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ConvRunPlan(start_ll_mask=put(start_ll_mask), run_len=put(run_len),
                       iobs_row=put(iobs[hid]), sig_row=put(sig[hid]),
                       tail_mask=put(tail_mask), max_run=max_run)


def conv_start_sums(ipred: torch.Tensor, plan: ConvRunPlan) -> torch.Tensor:
    """Per-row convolved prediction at run-start rows (other rows hold
    partial sums; consumers multiply by start_ll_mask). Works on (..., N)."""
    total = torch.zeros_like(ipred)
    for k in range(plan.max_run):
        shifted = ipred if k == 0 else torch.nn.functional.pad(
            ipred[..., k:], (0, k))
        total = total + shifted * (k < plan.run_len)
    return total
