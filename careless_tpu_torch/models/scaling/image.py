"""Image-conditioned scaling models.

Counterpart of careless_tpu/models/scaling/image.py:28-93. ImageScaler: one
scalar per image, the first pegged to 1, gathered by image_id through the
planned gather. HybridImageScaler: the MLP's Normal times the image scale,
Normal(a * loc, |a| * scale). NeuralImageScaler (--image-layers): the MLP's
hidden layers (K1 trunk-only from 2 layers), then per-image dense banks
gathered by image_id, then the MLP's f32 head.

The banks are plain PyTorch, as they are plain XLA in the JAX package, and
f32 whatever --mlp-dtype says (JAX applies no bf16 there). `w[image_id]`
materialises an (N, width, width) f32 batch: 400 MB per bank at 1M
observations of width 10, which the card's 80 GB holds. Its gradient
scatters N rows into max_images with atomic adds on the card, so the banks'
gradients are not bitwise repeatable there (the trunk's still are).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.distributions import Normal
from ...ops.fused_mlp import leaky_relu
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


@dataclass(frozen=True)
class NeuralImageScaler:
    image_layers: int
    max_images: int
    mlp: MLPScaler

    def init(self, metadata_dim: int, device) -> dict:
        """The MLP's params and `image_layers` banks: w (max_images, width,
        width) at the identity and b (max_images, width) at zero."""
        w = self.mlp.width
        eye = torch.eye(w, device=device)
        layers = [{"w": eye.expand(self.max_images, w, w).clone(),
                   "b": torch.zeros((self.max_images, w), device=device)}
                  for _ in range(self.image_layers)]
        return {"mlp": self.mlp.init(metadata_dim, device),
                "image_layers": layers}

    def apply(self, params: dict, inputs: Inputs) -> Normal:
        x = self.mlp.network(params["mlp"], inputs.metadata)
        img = inputs.image_id.long()
        for layer in params["image_layers"]:
            x = torch.einsum("nui,ni->nu", layer["w"][img], x) \
                + layer["b"][img]
            x = leaky_relu(x, self.mlp.leakiness)
        return self.mlp.head(params["mlp"], x)
