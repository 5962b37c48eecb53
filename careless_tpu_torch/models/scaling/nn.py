"""MLP scaling model: metadata -> Normal distribution over scale factors.

Counterpart of careless_tpu/models/scaling/nn.py:31-156: identity-
initialised dense layers (d_in, d_out), leaky ReLU 0.01, a linear head to
(loc, raw scale), the exp or softplus bijector plus epsilon on the scale,
and an optional additive shift of loc (`scale_multiplier`, the std of the
intensities under softplus). Trunk and head run through K1
(ops/fused_mlp.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.distributions import Normal
from ...ops.fused_mlp import fused_mlp_trunk_head
from ..base import Inputs


def _identity(d_in: int, d_out: int, device) -> torch.Tensor:
    return torch.as_tensor(np.eye(d_in, d_out, dtype=np.float32),
                           device=device)


@dataclass(frozen=True)
class MLPScaler:
    n_layers: int
    width: int
    leakiness: float = 0.01
    epsilon: float = 1e-7
    scale_bijector: str = "softplus"  # 'softplus' | 'exp'
    scale_multiplier: Optional[float] = None

    def init(self, metadata_dim: int, device) -> dict:
        layers = []
        d = metadata_dim
        for _ in range(self.n_layers):
            layers.append({
                "w": _identity(d, self.width, device),
                "b": torch.zeros(self.width, device=device)})
            d = self.width
        return {"layers": layers,
                "out": {"w": _identity(d, 2, device),
                        "b": torch.zeros(2, device=device)}}

    def _biject_scale(self, raw: torch.Tensor) -> torch.Tensor:
        if self.scale_bijector == "softplus":
            return F.softplus(raw) + self.epsilon
        if self.scale_bijector == "exp":
            return torch.exp(raw) + self.epsilon
        raise ValueError(
            f"Unsupported scale bijector type, {self.scale_bijector}")

    def apply(self, params: dict, inputs: Inputs) -> Normal:
        loc, raw = fused_mlp_trunk_head(inputs.metadata, params["layers"],
                                        params["out"], self.leakiness)
        if self.scale_multiplier is not None:
            loc = loc + self.scale_multiplier
        return Normal(loc, self._biject_scale(raw))
