"""The packed per-observation inputs of a merge, as torch tensors.

Counterpart of careless_tpu/models/base.py: flat (N,) arrays per
observation and (N, d) metadata, on one explicit device. Laue data carries
`wavelength` and `harmonic_id` (is_laue); its intensities and uncertainties
are indexed by harmonic group (the first n_groups entries hold the group
values), not by row. Gather plans are derived data, built once on the host
from the GLOBAL table sizes; select/to drop them, and so does replace() of
any field they are built from. Multi-device training needs no
shard-padding mask and no stacked per-shard plans: each rank holds an
unpadded cut of the single-device layout and builds its own plans on it
(parallel/shard.py). Not ported: the TPU's lane-packed metadata
(PackedMeta), since the trunk kernel reads (N, d) directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..ops.chain_layout import chain_row_order
from ..ops.conv_runs import ConvRunPlan, make_conv_run_plan
from ..ops.plan_gather import (ChainGatherPlan, GatherPlan,
                               make_chain_gather_plan, make_gather_plan)


@dataclass(frozen=True)
class GatherPlans:
    refl: Optional[Union[GatherPlan, ChainGatherPlan]] = None  # z_f[refl_id]
    image: Optional[GatherPlan] = None     # for image_scales[image_id]
    harmonic: Optional[GatherPlan] = None  # Laue convolve over harmonic_id
    # the gather-free run-aligned Laue convolution of the training path
    harmonic_run: Optional[ConvRunPlan] = None


ROW_FIELDS = ("refl_id", "image_id", "file_id", "metadata", "intensities",
               "uncertainties", "wavelength", "harmonic_id")
# the fields the plans are built from: replacing one of them with the
# plans still attached would compute on stale ids, or (the Laue run plan
# bakes in intensities and uncertainties) score the wrong data
_PLAN_SOURCE_FIELDS = frozenset(("refl_id", "image_id", "metadata",
                                 "harmonic_id", "intensities",
                                 "uncertainties"))


@dataclass(frozen=True, eq=False)
class Inputs:
    refl_id: torch.Tensor        # (N,) int32 global reflection id
    image_id: torch.Tensor       # (N,) int32 globally renumbered image
    file_id: torch.Tensor        # (N,) int32 input file index
    metadata: torch.Tensor       # (N, d) f32 standardized metadata
    intensities: torch.Tensor    # (N,) f32; Laue: per harmonic group
    uncertainties: torch.Tensor  # (N,) f32; same layout as intensities
    wavelength: Optional[torch.Tensor] = None   # (N,) f32, Laue only
    harmonic_id: Optional[torch.Tensor] = None  # (N,) int32, Laue only
    plans: Optional[GatherPlans] = None

    @property
    def is_laue(self) -> bool:
        return self.harmonic_id is not None

    @property
    def n_obs(self) -> int:
        return self.refl_id.shape[0]

    @property
    def device(self) -> torch.device:
        return self.refl_id.device

    @staticmethod
    def from_arrays(refl_id, image_id, file_id, metadata, intensities,
                    uncertainties, wavelength=None, harmonic_id=None,
                    device: DeviceLike = None) -> "Inputs":
        dev = resolve_device(device)

        def i32(x):
            return None if x is None else torch.as_tensor(
                np.ascontiguousarray(np.asarray(x).reshape(-1),
                                     dtype=np.int32), device=dev)

        def f32(x):
            return None if x is None else torch.as_tensor(
                np.ascontiguousarray(np.asarray(x).reshape(-1),
                                     dtype=np.float32), device=dev)

        return Inputs(
            refl_id=i32(refl_id), image_id=i32(image_id),
            file_id=i32(file_id),
            metadata=torch.as_tensor(np.ascontiguousarray(
                np.atleast_2d(metadata), dtype=np.float32), device=dev),
            intensities=f32(intensities), uncertainties=f32(uncertainties),
            wavelength=f32(wavelength), harmonic_id=i32(harmonic_id))

    def _rows(self, fn) -> "Inputs":
        return Inputs(**{f: None if getattr(self, f) is None
                         else fn(getattr(self, f)) for f in ROW_FIELDS})

    def replace(self, **fields) -> "Inputs":
        """dataclasses.replace that keeps the plan invariant: replacing a
        field the plans are built from drops them (rebuild with
        with_plans)."""
        if (self.plans is not None and "plans" not in fields
                and _PLAN_SOURCE_FIELDS.intersection(fields)):
            fields["plans"] = None
        return dataclasses.replace(self, **fields)

    def to(self, device: DeviceLike) -> "Inputs":
        """The same rows on another device; plans are dropped (rebuild them
        there with with_plans)."""
        if same_device(device, self.device):
            return self
        return self._rows(lambda t: t.to(device))

    def select(self, idx) -> "Inputs":
        """Row-select every per-observation array; plans are dropped."""
        return self._rows(lambda t: t[idx])

    def sorted_by_refl(self) -> "Inputs":
        """Stable-sort rows by refl_id. The ELBO is a sum over rows, so the
        order does not change it; sorted ids make the z_f gather's backward
        permute the identity (ops/plan_gather.py). Mono only: Laue
        intensities are packed by group."""
        if self.is_laue:
            raise ValueError("cannot reorder Laue inputs (group packing)")
        order = torch.sort(self.refl_id.long(), stable=True).indices
        return self.select(order)

    def sorted_by_harmonic(self, n_refl: Optional[int] = None) -> "Inputs":
        """Reorder Laue rows so that harmonic groups are contiguous runs
        (host numpy, careless_tpu base.py:105-165).

        Without n_refl (or with group ids that are not 0..G-1): a stable
        sort by harmonic_id; group ids and the group-indexed intensities
        stay as packed. With n_refl: the harmonic-chain layout
        (ops/chain_layout.py), in which the refl gather windows in both
        directions; groups are renumbered to their new order and the
        group-indexed intensities and uncertainties repacked to match."""
        return self.harmonic_layout(n_refl)[0]

    def harmonic_layout(self, n_refl: Optional[int] = None
                        ) -> Tuple["Inputs", torch.Tensor,
                                   Optional[torch.Tensor]]:
        """(sorted_by_harmonic(n_refl), the original row of each of its
        rows, the original group id of each renumbered group or None where
        the groups keep their ids): the maps that put values computed on
        the reordered rows back in the original row and group order."""
        if not self.is_laue:
            raise ValueError("sorted_by_harmonic applies to Laue inputs only")
        hid = self.harmonic_id.cpu().numpy()
        uniq = np.unique(hid)
        dense = len(uniq) == 0 or (uniq[0] == 0
                                   and uniq[-1] == len(uniq) - 1)
        if n_refl is None or not dense:
            order = np.argsort(hid, kind="stable")
        else:
            order = chain_row_order(self.refl_id.cpu().numpy(), hid, n_refl)
        rows_of = torch.as_tensor(order, device=self.device)
        rows = self.select(rows_of)
        iobs, sig, new_hid = (self.intensities, self.uncertainties,
                              rows.harmonic_id)
        old_of_new = None
        if n_refl is not None and dense:
            h_sorted = hid[order]
            change = np.concatenate([[True], h_sorted[1:] != h_sorted[:-1]])
            old_of_new = torch.as_tensor(h_sorted[np.flatnonzero(change)],
                                         device=self.device).long()
            n_groups = old_of_new.shape[0]
            new_hid = torch.as_tensor(
                (np.cumsum(change) - 1).astype(np.int32), device=self.device)
            iobs, sig = iobs.clone(), sig.clone()
            iobs[:n_groups] = self.intensities[old_of_new]
            sig[:n_groups] = self.uncertainties[old_of_new]
        rows = rows.replace(intensities=iobs, uncertainties=sig,
                            harmonic_id=new_hid)
        return rows, rows_of, old_of_new

    def with_plans(self, n_refl: int, n_images: int) -> "Inputs":
        """Attach the gather plans. Both sizes MUST be the GLOBAL table
        sizes the model's parameters were built with, never inferred from
        this (possibly subset) Inputs. Laue inputs also get the harmonic
        convolve plan, the run plan and, on the chain layout, a
        ChainGatherPlan for the refl gather (careless_tpu base.py:188-206)."""
        harmonic = harmonic_run = refl = None
        if self.is_laue:
            harmonic = make_gather_plan(self.harmonic_id, self.n_obs)
            harmonic_run = make_conv_run_plan(
                self.harmonic_id, self.intensities, self.uncertainties)
            refl = make_chain_gather_plan(self.refl_id, self.harmonic_id,
                                          n_refl)
        if refl is None:
            refl = make_gather_plan(self.refl_id, n_refl)
        return self.replace(plans=GatherPlans(
            refl=refl, image=make_gather_plan(self.image_id, n_images),
            harmonic=harmonic, harmonic_run=harmonic_run))
