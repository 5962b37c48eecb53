"""Truncated-normal surrogate posterior over structure-factor amplitudes.

Counterpart of careless_tpu/models/merging/surrogate.py:27-54: one
truncated normal per reflection, loc through exp and scale through
exp + scale_shift. The truncation bounds are fixed; the raw parameters
live in the params dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ...ops.distributions import TruncatedNormal


@dataclass(frozen=True, eq=False)
class TruncatedNormalPosterior:
    low: Union[torch.Tensor, float] = 0.0
    high: Union[torch.Tensor, float] = 1e10
    scale_shift: float = 1e-7

    def init(self, loc, scale, device) -> dict:
        """Raw parameters whose constrained values equal loc/scale (numpy,
        computed as the JAX package does)."""
        loc = np.asarray(loc, np.float32)
        scale = np.asarray(scale, np.float32)
        return {
            "loc_raw": torch.as_tensor(np.log(loc), device=device),
            "scale_raw": torch.as_tensor(
                np.log(np.maximum(scale - self.scale_shift, 1e-30)),
                device=device),
        }

    def distribution(self, params: dict) -> TruncatedNormal:
        return TruncatedNormal(
            loc=torch.exp(params["loc_raw"]),
            scale=torch.exp(params["scale_raw"]) + self.scale_shift,
            low=self.low, high=self.high)
