"""Planned gather: `table[ids]` with a planned, deterministic backward.

Counterpart of careless_tpu/ops/plan_gather.py. The ELBO gathers the
posterior sample z_f by refl_id and the image scales by image_id. The ids
are static for a dataset, so a plan is built once on the host:

forward:  K2 (ops/table_gather.py), out[k] = table[ids[k]].
backward: the duplicate-index scatter-add as a segment sum. The cotangent
          is put in table-id order (a K2 gather by `perm`, skipped when the
          ids are already sorted, as on the training path's refl_id), then
          every table entry's gradient is a difference of an exclusive
          prefix sum at two boundaries. No atomics, so the result does not
          depend on the order in which threads run.

The prefix sum is two-level: an inclusive f32 cumsum inside each
_CHUNK-sized chunk plus an exclusive cumsum of the chunk totals. A flat f32
cumsum over 1M entries grows to sum(|contrib|) and loses ~|cs| * eps on
every boundary difference, which swamps short segments far from the start.
Here the two levels are differenced separately: the local part at its
chunk's magnitude, the chunk part (accumulated in f64 over the few
thousand chunks and carried as an f32 hi/lo pair) at the magnitude of the
chunks the segment spans. The JAX package adds the two levels before
differencing, which keeps a flat cumsum's error. The boundary lookups,
local_excl[pos] and the chunk prefix at pos // _CHUNK, are K2 gathers.

Left out, as answers to TPU costs only: the one-hot histogram and one-hot
MXU gathers, the chain layout, the streaming gather and the sort permute.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .table_gather import table_gather

_CHUNK = 512  # cumsum reset interval (see the module docstring)


@dataclass(frozen=True, eq=False)
class GatherPlan:
    """Static plan for gathering `table[ids]` and for its transpose.

    ids:    (n,) int32, validated to lie in [0, table_size)
    perm:   (n,) int32 stable argsort of ids, None when ids are sorted
    starts: (T,) int32 first position of id t in sorted order
    ends:   (T,) int32 one past its last position (ends[t] == starts[t+1])
    pos:    (T+1,) int32 boundary positions [starts..., n]
    cp_ids: (2 (T+1),) int32 pos // _CHUNK, the chunk of each boundary,
            then the same + m: the hi and lo halves of the chunk prefix,
            m = n // _CHUNK + 1 chunks
    """

    ids: torch.Tensor
    perm: Optional[torch.Tensor]
    starts: torch.Tensor
    ends: torch.Tensor
    pos: torch.Tensor
    cp_ids: torch.Tensor
    table_size: int


def make_gather_plan(ids: torch.Tensor, table_size: int) -> GatherPlan:
    """Build the plan on the host (numpy) and place it beside `ids`.

    table_size must be the GLOBAL table size the parameters were built
    with, never one inferred from a subset's ids."""
    device = ids.device
    ids_np = ids.detach().cpu().numpy().reshape(-1).astype(np.int64)
    n = len(ids_np)
    if n and (ids_np.min() < 0 or ids_np.max() >= table_size):
        raise ValueError(f"ids must lie in [0, {table_size}); found "
                         f"[{ids_np.min()}, {ids_np.max()}]")
    is_sorted = bool(np.all(ids_np[1:] >= ids_np[:-1])) if n > 1 else True
    if is_sorted:
        perm = None
        sorted_ids = ids_np
    else:
        perm = np.argsort(ids_np, kind="stable")
        sorted_ids = ids_np[perm]
    rng = np.arange(table_size)
    starts = np.searchsorted(sorted_ids, rng, side="left")
    ends = np.searchsorted(sorted_ids, rng, side="right")
    pos = np.concatenate([starts, [n]])
    m = (n + _CHUNK) // _CHUNK

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return GatherPlan(
        ids=i32(ids_np), perm=None if perm is None else i32(perm),
        starts=i32(starts), ends=i32(ends), pos=i32(pos),
        cp_ids=i32(np.concatenate([pos // _CHUNK, pos // _CHUNK + m])),
        table_size=int(table_size))


def segment_sum_by_plan(contrib: torch.Tensor, plan: GatherPlan
                        ) -> torch.Tensor:
    """out[t] = sum of contrib[k] over k with ids[k] == t, shape (T,)."""
    c = contrib if plan.perm is None else table_gather(contrib, plan.perm)
    n = c.shape[0]
    # pad with >= 1 zero so boundary position n indexes a real (zero) slot
    m = (n + _CHUNK) // _CHUNK
    c = torch.cat([c, c.new_zeros(m * _CHUNK - n)])
    local_cs = torch.cumsum(c.view(m, _CHUNK), dim=1)          # inclusive
    local_excl = torch.cat([c.new_zeros(m, 1), local_cs[:, :-1]],
                           dim=1).reshape(-1)
    totals = local_cs[:, -1].double()
    prefix = torch.cumsum(totals, 0) - totals                  # exclusive
    hi = prefix.float()
    lo = (prefix - hi.double()).float()
    local_b = table_gather(local_excl, plan.pos)
    chunk_b = table_gather(torch.cat([hi, lo]), plan.cp_ids)
    k = plan.pos.shape[0]
    hi_b, lo_b = chunk_b[:k], chunk_b[k:]
    return ((local_b[1:] - local_b[:-1])
            + ((hi_b[1:] - hi_b[:-1]) + (lo_b[1:] - lo_b[:-1])))


class _PlanGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        return table_gather(table, plan.ids)

    @staticmethod
    def backward(ctx, ct):
        return segment_sum_by_plan(ct.contiguous(), ctx.plan), None


def plan_gather(table: torch.Tensor, ids: torch.Tensor,
                plan: Optional[GatherPlan]) -> torch.Tensor:
    """`table[ids]` for a flat table through the plan built from `ids`."""
    if plan is None:
        raise ValueError("plan_gather needs a GatherPlan (Inputs.with_plans)")
    if ids.shape != plan.ids.shape:
        raise ValueError("ids do not match the plan they were given with")
    return _PlanGather.apply(table, plan)
