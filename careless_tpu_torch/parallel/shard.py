"""Observation and Monte Carlo sharding over ranks, one process per device.

Counterpart of careless_tpu/parallel/shard.py. The JAX package shards one
SPMD program with shard_map, which needs every shard to have the same
shape and the same static plan meta; so it pads the rows to a multiple of
the device count (a padding `mask`) and stacks per-shard plans under one
uniform window. Ranks of torch.distributed share no shape, so the port
shards without padding:

- mono: the refl-sorted rows of DataManager.planned_rows are cut into W
  contiguous ranges of ceil(n / W) rows, the last one shorter
  (host_observation_slice): rank r holds exactly the rows of the JAX
  package's shard r that are not padding, in the same order;
- Laue: the harmonic-chain layout (Inputs.sorted_by_harmonic(n_refl)) is
  cut only at chain boundaries, with the greedy balance of
  careless_tpu/parallel/shard.py:123-135, so that no chain straddles two
  shards (a straggler row widens a shard's gather windows and drops its
  chain plan). Each shard numbers its groups from 0 and takes its own
  groups' packed intensities and uncertainties, then its share of the
  never-hit group rows that follow them (the tail the convolved
  likelihood scores at 0), so that the shards' tails together are the
  unsharded run's.

So the sharded layout is the single-device layout, cut; each rank builds
its own plans on its rows (Inputs.with_plans at the global table sizes)
and needs neither pad_inputs_to_multiple nor _stack_gather_plans /
_stack_chain_plans. A Shard record tells the ELBO where its rows and
samples lie in the whole (VariationalMergingModel.elbo), so that every
row draws the scale noise of the unsharded run, and which rank carries
the KL.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..models.base import Inputs
from ..ops.chain_layout import chain_labels
from .distributed import host_observation_slice


@dataclass(frozen=True)
class Shard:
    """Where a rank's rows and samples lie in the whole merge: rows
    [row_offset, row_offset + n) of n_total, samples [samples[0],
    samples[1]) of the model's mc_samples (None: all)."""
    rank: int
    row_offset: int
    n_total: int
    samples: Optional[Tuple[int, int]] = None

    @property
    def carries_kl(self) -> bool:
        """Rank 0 alone adds the KL to its loss, so the sum over ranks
        counts it once."""
        return self.rank == 0


def check_devices(num_devices: int, available: int) -> None:
    """Refuse more devices than there are (careless_tpu/parallel/
    shard.py:33-38)."""
    if num_devices > available:
        raise ValueError(f"requested {num_devices} devices but only "
                         f"{available} available")


def sample_range(mc_samples: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank r's samples [r S / W, (r + 1) S / W) of the Monte Carlo axis;
    refuses an S that does not divide (careless_tpu/models/merging/
    variational.py:469-473)."""
    if mc_samples % world:
        raise ValueError(f"mc_samples={mc_samples} must divide evenly over "
                         f"{world} devices for MC-axis sharding")
    per = mc_samples // world
    return rank * per, (rank + 1) * per


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def laue_cuts(refl_id, harmonic_id, n_refl: int, world: int) -> List[int]:
    """The W + 1 row bounds of the Laue shards of a chain layout: groups
    contiguous and in order, cut only where a new chain starts. Walking the
    groups, shard s ends before the first chain-starting group that does
    not fit its ceil(n / W) rows, as careless_tpu/parallel/shard.py:123-135
    assigns them; that group is the first chain start past the shard's
    first row whose end lies past start + ceil(n / W)."""
    rid, hid = _host(refl_id).astype(np.int64), _host(harmonic_id)
    n = len(hid)
    starts = np.flatnonzero(np.concatenate([[True], hid[1:] != hid[:-1]]))
    ends = np.append(starts[1:], n)
    chain = chain_labels(rid, hid, n_refl)[rid[starts]]
    new_chain = np.concatenate([[True], chain[1:] != chain[:-1]])
    c_start, c_end = starts[new_chain], ends[new_chain]
    target = -(-n // world)
    cuts = [0]
    for _ in range(world - 1):
        lo = cuts[-1]
        i = int(np.searchsorted(c_end, lo + target, side="right"))
        i += int(np.searchsorted(c_start[i:], lo, side="right"))
        cuts.append(int(c_start[i]) if i < len(c_start) else n)
    return cuts + [n]


def shard_ranges(layout: Inputs, world: int,
                 n_refl: Optional[int] = None) -> List[Tuple[int, int]]:
    """Each rank's rows [lo, hi) of a single-device layout: mono by
    host_observation_slice, Laue (n_refl needed) by laue_cuts."""
    n = layout.n_obs
    if layout.is_laue:
        if n_refl is None:
            raise ValueError("Laue shards need n_refl (the chain cuts)")
        cuts = laue_cuts(layout.refl_id, layout.harmonic_id, n_refl, world)
        return list(zip(cuts[:-1], cuts[1:]))
    return [(s.start, s.stop) for s in
            (host_observation_slice(n, r, world) for r in range(world))]


def prepare_sharded_layout(inputs: Inputs, num_shards: int,
                           n_refl: Optional[int] = None
                           ) -> Tuple[Inputs, List[Tuple[int, int]]]:
    """(the single-device layout, each shard's row range): mono rows
    stably sorted by refl_id, Laue rows in the chain layout
    (sorted_by_harmonic(n_refl)), as DataManager.planned_rows lays them
    out, without plans."""
    inputs = inputs.replace(plans=None)
    if inputs.is_laue:
        layout = inputs.sorted_by_harmonic(n_refl)
    else:
        layout = inputs.sorted_by_refl()
    return layout, shard_ranges(layout, num_shards, n_refl)


def _laue_rows(layout: Inputs, lo: int, hi: int) -> Inputs:
    """Rows [lo, hi) of a chain layout with its groups numbered from 0,
    their packed intensities and uncertainties first, then the shard's
    share of the never-hit tail rows: rows [G + lo - g_lo, G + hi - g_hi)
    of the whole table (G groups; the shard's groups [g_lo, g_hi)), so
    that the shards' tails partition the whole layout's."""
    hid = layout.harmonic_id
    n_groups = int(hid[-1]) + 1
    g_lo, g_hi = int(hid[lo]), int(hid[hi - 1]) + 1
    if n_groups != int(torch.unique(hid).numel()):
        raise ValueError("Laue shards need group ids 0 .. G - 1 in order "
                         "(the chain layout)")

    def table(t):
        return torch.cat([t[g_lo:g_hi],
                          t[n_groups + lo - g_lo:n_groups + hi - g_hi]])
    rows = layout.select(slice(lo, hi))
    return rows.replace(harmonic_id=rows.harmonic_id - g_lo,
                        intensities=table(layout.intensities),
                        uncertainties=table(layout.uncertainties))


def shard_inputs(planned: Inputs, rank: int, world: int, n_refl: int,
                 n_images: int, device: DeviceLike = None
                 ) -> Tuple[Inputs, Shard]:
    """Rank `rank`'s rows of the single-device layout `planned`
    (DataManager.planned_rows(...).inputs) on `device` (default: where
    they are), with their own plans at the global table sizes (the
    counterpart of careless_tpu/parallel/shard.py:334-406), and the Shard
    that places them in the whole."""
    lo, hi = shard_ranges(planned, world, n_refl)[rank]
    if hi <= lo:
        raise ValueError(f"{planned.n_obs} observations leave shard {rank} "
                         f"of {world} empty")
    if planned.is_laue:
        rows = _laue_rows(planned.replace(plans=None), lo, hi)
    else:
        rows = planned.select(slice(lo, hi))
    if device is not None:
        rows = rows.to(device)
    return (rows.with_plans(n_refl, n_images),
            Shard(rank, lo, planned.n_obs))


def sample_shard(mc_samples: int, rank: int, world: int, n_obs: int
                 ) -> Shard:
    """The Shard of rank `rank` on the Monte Carlo axis: every row, the
    rank's samples (sample_range)."""
    return Shard(rank, 0, n_obs, sample_range(mc_samples, rank, world))
