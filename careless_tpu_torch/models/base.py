"""The packed per-observation inputs of a merge, as torch tensors.

Counterpart of careless_tpu/models/base.py for mono data: flat (N,) arrays
per observation and (N, d) metadata, on one explicit device. Gather plans
are derived data; they are built once on the host from the GLOBAL table
sizes, and select/to drop them. Not ported: the Laue fields, the
shard-padding mask and per-shard plans (multi-device), and the TPU's lane-
packed metadata (PackedMeta): the trunk kernel reads (N, d) directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..ops.plan_gather import GatherPlan, make_gather_plan


@dataclass(frozen=True)
class GatherPlans:
    refl: Optional[GatherPlan] = None   # for z_f[refl_id]
    image: Optional[GatherPlan] = None  # for image_scales[image_id]


_ROW_FIELDS = ("refl_id", "image_id", "file_id", "metadata", "intensities",
               "uncertainties")


@dataclass(frozen=True, eq=False)
class Inputs:
    refl_id: torch.Tensor        # (N,) int32 global reflection id
    image_id: torch.Tensor       # (N,) int32 globally renumbered image
    file_id: torch.Tensor        # (N,) int32 input file index
    metadata: torch.Tensor       # (N, d) f32 standardized metadata
    intensities: torch.Tensor    # (N,) f32
    uncertainties: torch.Tensor  # (N,) f32
    plans: Optional[GatherPlans] = None

    @property
    def n_obs(self) -> int:
        return self.refl_id.shape[0]

    @property
    def device(self) -> torch.device:
        return self.refl_id.device

    @staticmethod
    def from_arrays(refl_id, image_id, file_id, metadata, intensities,
                    uncertainties, device: DeviceLike = None) -> "Inputs":
        dev = resolve_device(device)

        def i32(x):
            return torch.as_tensor(np.ascontiguousarray(
                np.asarray(x).reshape(-1), dtype=np.int32), device=dev)

        def f32(x):
            return torch.as_tensor(np.ascontiguousarray(
                np.asarray(x).reshape(-1), dtype=np.float32), device=dev)

        return Inputs(
            refl_id=i32(refl_id), image_id=i32(image_id),
            file_id=i32(file_id),
            metadata=torch.as_tensor(np.ascontiguousarray(
                np.atleast_2d(metadata), dtype=np.float32), device=dev),
            intensities=f32(intensities), uncertainties=f32(uncertainties))

    def to(self, device: DeviceLike) -> "Inputs":
        """The same rows on another device; plans are dropped (rebuild them
        there with with_plans)."""
        if same_device(device, self.device):
            return self
        return Inputs(**{f: getattr(self, f).to(device) for f in _ROW_FIELDS})

    def select(self, idx) -> "Inputs":
        """Row-select every per-observation array; plans are dropped."""
        return Inputs(**{f: getattr(self, f)[idx] for f in _ROW_FIELDS})

    def sorted_by_refl(self) -> "Inputs":
        """Stable-sort rows by refl_id. The ELBO is a sum over rows, so the
        order does not change it; sorted ids make the z_f gather's backward
        permute the identity (ops/plan_gather.py)."""
        order = torch.sort(self.refl_id.long(), stable=True).indices
        return self.select(order)

    def with_plans(self, n_refl: int, n_images: int) -> "Inputs":
        """Attach the gather plans. Both sizes MUST be the GLOBAL table
        sizes the model's parameters were built with, never inferred from
        this (possibly subset) Inputs."""
        return dataclasses.replace(self, plans=GatherPlans(
            refl=make_gather_plan(self.refl_id, n_refl),
            image=make_gather_plan(self.image_id, n_images)))
