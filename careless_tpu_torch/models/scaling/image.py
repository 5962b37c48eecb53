"""Image-conditioned scaling models.

Counterpart of careless_tpu/models/scaling/image.py:28-61. ImageScaler: one
scalar per image, the first pegged to 1, gathered by image_id through the
planned gather. HybridImageScaler: the MLP's Normal times the image scale,
Normal(a * loc, |a| * scale). NeuralImageScaler is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.distributions import Normal
from ...ops.plan_gather import plan_gather
from ..base import Inputs
from .nn import MLPScaler


@dataclass(frozen=True)
class ImageScaler:
    max_images: int

    def init(self, device) -> dict:
        return {"scales": torch.ones(self.max_images - 1, device=device)}

    def scales(self, params: dict) -> torch.Tensor:
        s = params["scales"]
        return torch.cat([torch.ones(1, dtype=s.dtype, device=s.device), s])

    def apply(self, params: dict, inputs: Inputs) -> torch.Tensor:
        return plan_gather(self.scales(params), inputs.image_id,
                           inputs.plans.image if inputs.plans else None)


@dataclass(frozen=True)
class HybridImageScaler:
    mlp: MLPScaler
    image: ImageScaler

    def init(self, metadata_dim: int, device) -> dict:
        return {"mlp": self.mlp.init(metadata_dim, device),
                "image": self.image.init(device)}

    def apply(self, params: dict, inputs: Inputs) -> Normal:
        q = self.mlp.apply(params["mlp"], inputs)
        a = self.image.apply(params["image"], inputs)
        return Normal(a * q.loc, torch.abs(a) * q.scale)
