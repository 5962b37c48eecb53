"""MLP scaling model: metadata -> Normal distribution over scale factors.

Counterpart of careless_tpu/models/scaling/nn.py:31-156: identity-
initialised dense layers (d_in, d_out), leaky ReLU 0.01, a linear head to
(loc, raw scale), the exp or softplus bijector plus epsilon on the scale,
and an optional additive shift of loc (`scale_multiplier`, the std of the
intensities under softplus). `mlp_dtype` "bfloat16" gives the trunk's
products bf16 operands with f32 sums (--mlp-dtype).

Routing, as the JAX package's: from 2 layers (and max(d, width) >= 2)
trunk and head run as one K1 (ops/fused_mlp.py), whose bf16 head is a bf16
product too. Otherwise `network` runs K1 trunk-only from 2 layers, else the
plain layer loop (JAX runs no kernel there), and `head` an f32 product.

The loop is nn.py:102-129's: g = 128 // max(d, width) observations side by
side in one row against block-diagonal weights kron(I_g, W). In f32 that
is the unpacked product exactly. In bf16 (`_mm`: both operands cast) its
gradient is JAX's autodiff through the casts, which rounds each gradient
product's result to bf16 (not the kernel's operand-rounding backward), and
the packing shows: each slot's partial dW is rounded before the g slots
are summed. The port keeps the packing so as to compute the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.distributions import Normal
from ...ops.fused_mlp import (fused_mlp_trunk, fused_mlp_trunk_head,
                              leaky_relu, round_bf16)
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
    mlp_dtype: str = "float32"        # 'float32' | 'bfloat16'

    @property
    def bf16(self) -> bool:
        return self.mlp_dtype == "bfloat16"

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

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The layer loop's product (nn.py:88-94), bf16 operands when
        mlp_dtype asks for them."""
        if self.bf16:
            return round_bf16(a) @ round_bf16(b)
        return a @ b

    def network(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The hidden layers over metadata x (N, d): (N, width)."""
        if self.n_layers >= 2:
            return fused_mlp_trunk(x, params["layers"], self.leakiness,
                                   bf16=self.bf16)
        n, d = x.shape
        g = max(1, 128 // max(d, self.width))
        x = F.pad(x, (0, 0, 0, -n % g)).reshape(-1, g * d)
        eye = torch.eye(g, dtype=x.dtype, device=x.device)
        for layer in params["layers"]:
            w = layer["w"]
            w_bd = (eye[:, None, :, None] * w[None, :, None, :]).reshape(
                g * w.shape[0], g * w.shape[1])
            x = leaky_relu(self._mm(x, w_bd) + layer["b"].repeat(g),
                           self.leakiness)
        return x.reshape(-1, x.shape[1] // g)[:n]

    def _normal(self, loc: torch.Tensor, raw: torch.Tensor) -> Normal:
        if self.scale_multiplier is not None:
            loc = loc + self.scale_multiplier
        return Normal(loc, self._biject_scale(raw))

    def head(self, params: dict, x: torch.Tensor) -> Normal:
        """The f32 linear head over (N, width) activations."""
        y = x @ params["out"]["w"] + params["out"]["b"]
        return self._normal(y[:, 0], y[:, 1])

    def apply(self, params: dict, inputs: Inputs) -> Normal:
        x = inputs.metadata
        if self.n_layers >= 2 and max(x.shape[-1], self.width) >= 2:
            return self._normal(*fused_mlp_trunk_head(
                x, params["layers"], params["out"], self.leakiness,
                bf16=self.bf16))
        return self.head(params, self.network(params, x))
