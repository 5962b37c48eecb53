"""Planned gather: `table[ids]` with a planned, deterministic backward.

Counterpart of careless_tpu/ops/plan_gather.py. The ELBO gathers the
posterior sample z_f by refl_id and the image scales by image_id; Laue
convolves predictions into harmonic groups (the transpose of a gather). The
ids are static for a data set, so a plan is built once on the host:

forward:  K2 (ops/table_gather.py), out[k] = table[ids[k]]; K5 for a table
          past the TPU's VMEM cap whose ids window (`stream`, as below).
backward: the duplicate-index scatter-add as a segment sum. The cotangent
          is put in table-id order (a gather by `perm`, skipped when the
          ids are already sorted, as on the mono path's refl_id), then
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

Laue (the harmonic-chain layout of ops/chain_layout.py): the refl gather
runs through a ChainGatherPlan, z_f permuted to chain order (K2 by sigma,
its transpose K2 by sigma_inv), then gathered by the renumbered ids. Its
backward permute is quasi-identity and carries a window plan (`perm_plan`);
past the VMEM cap (`stream`) it runs through K5, else through K2 by perm.
The `stream` predicates are the JAX package's own, at the same constants,
so K5 runs exactly where the JAX package runs windowed_gather_stream; the
windows themselves are the JAX package's too (_plan_windows).

Left out, as answers to TPU costs only: the one-hot histogram and one-hot
MXU gathers, the sort permute and the non-streaming windows of K2 (the
CUDA K2 takes flat ids). Where the JAX package takes the one-hot
histogram backward (small unsorted tables, 1-D cotangents), the port
permutes and takes the segment sum: the same sums in another order. On
the chain plan that permute is K5 once it streams, so at mc = 1 with more
than 2,097,152 observations and a refl table within the histogram cap
(32,768 entries, 65,536 from 4M observations) the port runs K5 where the
JAX package runs no stream kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .chain_layout import chain_permutation
from .table_gather import (BLOCK_ROWS, LANES, _check_tiles, table_gather,
                           windowed_gather_stream)

_CHUNK = 512  # cumsum reset interval (see the module docstring)
BLOCK_OBS = BLOCK_ROWS * LANES  # entries per window tile
MAX_WINDOW_CHUNKS = 80      # widest window of a table gather, in chunks
MAX_TABLE_ROWS = 16384      # the TPU's VMEM cap, in rows of 128 entries
# the quasi-identity backward permutation spans >= 64 chunks (a tile of
# 8192 consecutive positions alone covers 64); its plan gives up at 160
PERM_WINDOW_CHUNKS = 160
MAX_STREAM_TABLE_ROWS = 1 << 20  # table cap of the streaming kernel


def _check_ids(name: str, t: torch.Tensor, bound: int) -> None:
    """A plan's id tensor: int32, contiguous, 16-byte aligned on the card
    (K2 and K5 load ids 16 bytes at a time) and inside [0, bound). Checked
    once, when the plan is built, so that the gathers' launches need not."""
    if t.dtype != torch.int32 or not t.is_contiguous() or (
            t.is_cuda and t.data_ptr() % 16):
        raise ValueError(f"plan ids {name} must be contiguous int32 (16-byte "
                         f"aligned on the card); got {t.dtype}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= bound):
        raise ValueError(f"plan ids {name} must lie in [0, {bound}); found "
                         f"[{int(t.min())}, {int(t.max())}]")


@dataclass(frozen=True, eq=False)
class WindowPlan:
    """A windowed gather's tiles (ops/table_gather.py, K5's contract).

    ids2d:  (R, 128) int32 ids, padded with the last id to whole tiles
    bases:  (R // block_rows,) int32 first table row of each tile's window
    window: window width in rows of 128 entries
    block_rows: tile height in rows of 128
    stream: past the VMEM cap: the gather runs through K5
    table_size: entries of the table gathered from; every window lies
            inside it, zero-padded to whole rows (or starts at row 0 when
            it is wider than the table)
    """

    ids2d: torch.Tensor
    bases: torch.Tensor
    window: int
    block_rows: int
    stream: bool
    table_size: int

    def __post_init__(self):
        _check_ids("ids2d", self.ids2d, self.table_size)
        rows = -(-self.table_size // LANES)
        _check_ids("bases", self.bases, max(rows - self.window, 0) + 1)
        _check_tiles(self.ids2d, self.bases, self.window, self.block_rows)

    def gather(self, table: torch.Tensor, n: int) -> torch.Tensor:
        """table[ids[:n]] through K5 (the plain version on the CPU)."""
        return windowed_gather_stream(table, self.ids2d, self.bases,
                                      self.window, self.block_rows)[:n]


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
    window: the forward's stream window (tables past the VMEM cap whose
            ids window), else None
    perm_plan: window plan of the gather by `perm` (the chain layout's
            quasi-identity backward permute), else None
    blocks: K blocks of the table and of the sorted ids (block_plan),
            else None
    """

    ids: torch.Tensor
    perm: Optional[torch.Tensor]
    starts: torch.Tensor
    ends: torch.Tensor
    pos: torch.Tensor
    cp_ids: torch.Tensor
    table_size: int
    window: Optional[WindowPlan] = None
    perm_plan: Optional[WindowPlan] = None
    blocks: Optional["RowBlocks"] = None

    def __post_init__(self):
        n = self.ids.numel()
        _check_ids("ids", self.ids, self.table_size)
        if self.perm is not None:
            _check_ids("perm", self.perm, n)
        _check_ids("pos", self.pos, self.sum_len + 1)
        _check_ids("cp_ids", self.cp_ids, 2 * self.chunks)

    @property
    def stream(self) -> bool:
        return self.window is not None and self.window.stream

    @property
    def sum_len(self) -> int:
        """Entries of the cotangent the segment sum takes its prefix sums
        over: the ids' count, or the blocks' padded length."""
        return self.ids.numel() if self.blocks is None else self.blocks.padded

    @property
    def chunks(self) -> int:
        """_CHUNK-sized chunks of the segment sum (at least one zero pad)."""
        return (self.sum_len + _CHUNK) // _CHUNK


@dataclass(frozen=True, eq=False)
class RowBlocks:
    """A GatherPlan over K independent problems laid end to end (the halves
    of parallel/xval.py): block k owns table entries [k T, (k + 1) T) and a
    run of the sorted ids. Its segment sum places block k's sorted
    cotangent at a multiple of _CHUNK (`index`, padded with zeros to
    `padded` entries), takes each block's chunk sums and chunk prefix on
    their own (PyTorch's row scan on the card sums a row in an order that
    depends on how many rows it is given) and holds each block's own T + 1
    boundaries, so that every block's sums are those of its problem alone,
    in the same order as its own plan takes them."""

    count: int            # K
    index: torch.Tensor   # (n,) int64 position of each sorted entry
    padded: int           # a multiple of _CHUNK
    chunks: tuple         # each block's chunks, then the trailing ones


@dataclass(frozen=True, eq=False)
class ChainGatherPlan:
    """The Laue refl gather on the chain layout: sigma[new] = old (the
    chain renumbering); `inner` gathers the permuted table by the
    renumbered ids. Inputs.refl_id and the model's tables stay in
    canonical order; the permutation lives in this plan."""

    sigma: torch.Tensor      # (T,) int32, new -> old
    sigma_inv: torch.Tensor  # (T,) int32, old -> new
    inner: GatherPlan
    table_size: int

    def __post_init__(self):
        _check_ids("sigma", self.sigma, self.table_size)
        _check_ids("sigma_inv", self.sigma_inv, self.table_size)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                           device=device)


def _window_plan(planned, block_rows: int, stream: bool, table_size: int,
                 device) -> Optional[WindowPlan]:
    ids2d, bases, window = planned
    if ids2d is None:
        return None
    return WindowPlan(ids2d=_i32(ids2d, device), bases=_i32(bases, device),
                      window=window, block_rows=block_rows, stream=stream,
                      table_size=int(table_size))


def _plan_windows(ids, table_size: int, max_chunks: int = MAX_WINDOW_CHUNKS,
                  max_rows: int = MAX_TABLE_ROWS,
                  block_obs: int = BLOCK_OBS):
    """(ids2d, bases, window) of a windowed gather, or (None, None, 0)
    when the table has more than max_rows rows or a tile's ids span more
    than max_chunks rows of a table wider than that. The max_rows default
    is bound here, when the function is defined, as in the JAX package."""
    n = len(ids)
    table_rows = -(-table_size // LANES)
    if n == 0 or table_rows > max_rows:
        return None, None, 0
    rows = -(-n // LANES)
    rows_pad = -(-rows // (block_obs // LANES)) * (block_obs // LANES)
    # pad with the LAST id, never 0: on (quasi-)sorted ids a 0-pad makes
    # the final tile span the whole table
    flat = np.full(rows_pad * LANES, ids[-1], np.int32)
    flat[:n] = ids
    ids2d = flat.reshape(rows_pad, LANES)
    n_tiles = rows_pad * LANES // block_obs
    tiles = flat.reshape(n_tiles, block_obs)
    lo = tiles.min(axis=1) // LANES
    hi = tiles.max(axis=1) // LANES
    window = int((hi - lo).max()) + 1
    if window > max_chunks:
        if table_rows > max_chunks:
            return None, None, 0
        lo = np.zeros(n_tiles, np.int64)   # small table: cover it whole
        window = table_rows
    # clamp so [base, base + window) stays inside the padded table
    bases = np.minimum(lo, max(table_rows - window, 0)).astype(np.int32)
    return ids2d, bases, int(window)


def _boundaries(sorted_ids: np.ndarray, table_size: int, device) -> dict:
    n = len(sorted_ids)
    rng = np.arange(table_size)
    starts = np.searchsorted(sorted_ids, rng, side="left")
    ends = np.searchsorted(sorted_ids, rng, side="right")
    pos = np.concatenate([starts, [n]])
    m = (n + _CHUNK) // _CHUNK
    return dict(starts=_i32(starts, device), ends=_i32(ends, device),
                pos=_i32(pos, device),
                cp_ids=_i32(np.concatenate([pos // _CHUNK, pos // _CHUNK + m]),
                            device),
                table_size=int(table_size))


def make_gather_plan(ids: torch.Tensor, table_size: int) -> GatherPlan:
    """Build the plan on the host (numpy) and place it beside `ids`.

    table_size must be the GLOBAL table size the parameters were built
    with, never one inferred from a subset's ids. Past the VMEM cap
    (MAX_TABLE_ROWS, read at call time) the plan also gets the stream
    window, when the ids window (careless_tpu plan_gather.py:199-206)."""
    device = ids.device
    ids_np = ids.detach().cpu().numpy().reshape(-1).astype(np.int64)
    n = len(ids_np)
    is_sorted = bool(np.all(ids_np[1:] >= ids_np[:-1])) if n > 1 else True
    if is_sorted:
        perm = None
        sorted_ids = ids_np
    else:
        perm = np.argsort(ids_np, kind="stable")
        sorted_ids = ids_np[perm]
    window = None
    if -(-table_size // LANES) > MAX_TABLE_ROWS:
        planned = _plan_windows(ids_np, table_size,
                                max_rows=MAX_STREAM_TABLE_ROWS)
        window = _window_plan(planned, BLOCK_OBS // LANES, True, table_size,
                              device)
    return GatherPlan(
        ids=_i32(ids_np, device), perm=None if perm is None else _i32(perm,
                                                                     device),
        window=window, **_boundaries(sorted_ids, table_size, device))


def block_plan(plan: GatherPlan, bounds) -> GatherPlan:
    """`plan` (of sorted-id runs bounds[k]:bounds[k + 1], each in table
    entries [k T, (k + 1) T) for T = table_size / K) with RowBlocks: the
    boundaries and chunk ids of each run computed as its own plan
    computes them, at its block's offset."""
    k = len(bounds) - 1
    t = plan.table_size // k
    device = plan.ids.device
    ids = plan.ids.cpu().numpy().astype(np.int64)
    if plan.perm is not None:
        ids = ids[plan.perm.cpu().numpy()]
    lengths = np.diff(bounds)
    padded = (lengths + _CHUNK) // _CHUNK * _CHUNK  # each run as its own
    offsets = np.concatenate([[0], np.cumsum(padded)])
    index = np.concatenate([np.arange(n) + o
                            for n, o in zip(lengths, offsets)])
    pos = np.concatenate([
        np.concatenate([np.searchsorted(ids[a:b] - j * t, np.arange(t)),
                        [b - a]]) + offsets[j]
        for j, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))])
    m = (int(offsets[-1]) + _CHUNK) // _CHUNK
    chunks = (padded // _CHUNK).tolist()
    return dataclasses.replace(
        plan, pos=_i32(pos, device),
        cp_ids=_i32(np.concatenate([pos // _CHUNK, pos // _CHUNK + m]),
                    device),
        starts=_i32(np.concatenate([p[:-1] for p in np.split(pos, k)]),
                    device),
        ends=_i32(np.concatenate([p[1:] for p in np.split(pos, k)]), device),
        blocks=RowBlocks(k, torch.as_tensor(index, device=device),
                         int(offsets[-1]), tuple(chunks + [m - sum(chunks)])))


def make_chain_gather_plan(refl_id: torch.Tensor, harmonic_id: torch.Tensor,
                           table_size: int) -> Optional[ChainGatherPlan]:
    """The chain layout's refl-gather plan, or None when the layout does
    not window (rows not in chain order, or spans past the caps); callers
    then take make_gather_plan (careless_tpu plan_gather.py:786-838)."""
    device = refl_id.device
    ids = refl_id.detach().cpu().numpy().reshape(-1)
    n = len(ids)
    if n == 0:
        return None
    sigma, sigma_inv = chain_permutation(
        ids, harmonic_id.detach().cpu().numpy(), table_size)
    local = sigma_inv[ids]
    is_sorted = bool(np.all(local[1:] >= local[:-1])) if n > 1 else True
    if _plan_windows(local, table_size)[0] is None:
        return None
    perm = perm_plan = None
    sorted_local = local
    if not is_sorted:
        perm = np.argsort(local, kind="stable").astype(np.int32)
        sorted_local = local[perm]
        # 2048-entry tiles for the TPU's VMEM kernel, 8192 for the stream
        stream = -(-n // LANES) > MAX_TABLE_ROWS
        block = BLOCK_OBS if stream else 2048
        planned = _plan_windows(perm, n, max_chunks=PERM_WINDOW_CHUNKS,
                                max_rows=MAX_STREAM_TABLE_ROWS,
                                block_obs=block)
        perm_plan = _window_plan(planned, block // LANES, stream, n, device)
        if perm_plan is None:
            return None  # displacement too large for the windows
    inner = GatherPlan(ids=_i32(local, device),
                       perm=None if perm is None else _i32(perm, device),
                       perm_plan=perm_plan,
                       **_boundaries(sorted_local, table_size, device))
    return ChainGatherPlan(sigma=_i32(sigma, device),
                           sigma_inv=_i32(sigma_inv, device), inner=inner,
                           table_size=int(table_size))


def _apply_perm(contrib: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """contrib[perm]: the backward permute into table-id order; K5 when
    the plan's permute streams, else K2."""
    if plan.perm is None:
        return contrib
    pp = plan.perm_plan
    if pp is not None and pp.stream:
        return pp.gather(contrib, contrib.shape[0])
    return table_gather(contrib, plan.perm)


def segment_sum_by_plan(contrib: torch.Tensor, plan: GatherPlan
                        ) -> torch.Tensor:
    """out[t] = sum of contrib[k] over k with ids[k] == t, shape (T,)."""
    c = _apply_perm(contrib, plan)
    blocks = plan.blocks
    if blocks is not None:
        c = c.new_zeros(blocks.padded).index_copy_(0, blocks.index, c)
    n = c.shape[0]
    # pad with >= 1 zero so boundary position n indexes a real (zero) slot
    m = (n + _CHUNK) // _CHUNK
    c = torch.cat([c, c.new_zeros(m * _CHUNK - n)])
    if blocks is None:
        local_cs = torch.cumsum(c.view(m, _CHUNK), dim=1)      # inclusive
    else:   # block by block: the card's row scan varies with the rows
        local_cs = torch.cat([torch.cumsum(v, dim=1) for v in
                              c.view(m, _CHUNK).split(blocks.chunks)])
    local_excl = torch.cat([c.new_zeros(m, 1), local_cs[:, :-1]],
                           dim=1).reshape(-1)
    totals = local_cs[:, -1].double()
    if blocks is None:
        prefix = torch.cumsum(totals, 0) - totals              # exclusive
    else:   # each block's own, as its own plan takes it
        prefix = torch.cat([torch.cumsum(t, 0) - t
                            for t in totals.split(blocks.chunks)])
    hi = prefix.float()
    lo = (prefix - hi.double()).float()
    local_b = table_gather(local_excl, plan.pos)
    chunk_b = table_gather(torch.cat([hi, lo]), plan.cp_ids)
    k = plan.pos.shape[0]
    hi_b, lo_b = chunk_b[:k], chunk_b[k:]
    if blocks is not None:   # each block's T + 1 boundaries in a row
        local_b, hi_b, lo_b = (x.view(blocks.count, -1)
                               for x in (local_b, hi_b, lo_b))
    out = ((local_b[..., 1:] - local_b[..., :-1])
           + ((hi_b[..., 1:] - hi_b[..., :-1])
              + (lo_b[..., 1:] - lo_b[..., :-1])))
    return out.reshape(-1)


def _forward_gather(table: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    if plan.stream:
        return plan.window.gather(table, plan.ids.shape[0])
    return table_gather(table, plan.ids)


class _PlanGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        return _forward_gather(table, plan)

    @staticmethod
    def backward(ctx, ct):
        return segment_sum_by_plan(ct.contiguous(), ctx.plan), None


class _ChainPermute(torch.autograd.Function):
    """x[sigma]; its transpose is the inverse permutation, ct[sigma_inv]."""

    @staticmethod
    def forward(ctx, x, sigma, sigma_inv):
        ctx.sigma_inv = sigma_inv
        return table_gather(x, sigma)

    @staticmethod
    def backward(ctx, ct):
        return table_gather(ct.contiguous(), ctx.sigma_inv), None, None


class _PlanConvolve(torch.autograd.Function):
    """Forward: the planned segment sum; backward: the gather of the
    cotangent by ids, through K5 when the plan streams."""

    @staticmethod
    def forward(ctx, value, plan):
        ctx.plan = plan
        return segment_sum_by_plan(value, plan)

    @staticmethod
    def backward(ctx, ct):
        return _forward_gather(ct.contiguous(), ctx.plan), None


def plan_gather(table: torch.Tensor, ids: torch.Tensor,
                plan: Union[GatherPlan, ChainGatherPlan, None]
                ) -> torch.Tensor:
    """`table[ids]` for a flat table through the plan built from `ids`."""
    if plan is None:
        raise ValueError("plan_gather needs a GatherPlan (Inputs.with_plans)")
    if isinstance(plan, ChainGatherPlan):
        if ids.shape != plan.inner.ids.shape:
            raise ValueError("ids do not match the plan they were given with")
        z_perm = _ChainPermute.apply(table, plan.sigma, plan.sigma_inv)
        return _PlanGather.apply(z_perm, plan.inner)
    if ids.shape != plan.ids.shape:
        raise ValueError("ids do not match the plan they were given with")
    return _PlanGather.apply(table, plan)


def plan_convolve(value: torch.Tensor, ids: torch.Tensor,
                  plan: Optional[GatherPlan]) -> torch.Tensor:
    """out[g] = sum of value[o] over o with ids[o] == g, the length of
    value (the plan's table size must equal it): the Laue harmonic
    convolution, the transpose of plan_gather."""
    if plan is None:
        raise ValueError("plan_convolve needs a GatherPlan "
                         "(Inputs.with_plans)")
    if ids.shape != plan.ids.shape or plan.table_size != value.shape[0]:
        raise ValueError("value and ids do not match the plan")
    return _PlanConvolve.apply(value.contiguous(), plan)
