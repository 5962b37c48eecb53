"""Surrogate posteriors over structure-factor amplitudes.

Counterpart of careless_tpu/models/merging/surrogate.py:27-78: one
distribution per reflection, loc through exp and scale through
exp + scale_shift, the raw parameters (loc_raw, scale_raw) in the params
dict. TruncatedNormalPosterior's truncation bounds are fixed;
RiceWoolfsonPosterior (not wired to the CLI) is FoldedNormal for centric
reflections and Rice for acentric ones. `family` is the distribution
class, whose draw_noise the ELBO draws the reflection samples' noise
with.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Union

import numpy as np
import torch

from ...ops.distributions import RiceWoolfson, TruncatedNormal


def _raw(loc, scale, scale_shift: float, device) -> dict:
    """Raw parameters whose constrained values equal loc/scale (numpy,
    computed as the JAX package does)."""
    loc = np.asarray(loc, np.float32)
    scale = np.asarray(scale, np.float32)
    return {
        "loc_raw": torch.as_tensor(np.log(loc), device=device),
        "scale_raw": torch.as_tensor(
            np.log(np.maximum(scale - scale_shift, 1e-30)), device=device),
    }


@dataclass(frozen=True, eq=False)
class TruncatedNormalPosterior:
    low: Union[torch.Tensor, float] = 0.0
    high: Union[torch.Tensor, float] = 1e10
    scale_shift: float = 1e-7
    family: ClassVar[type] = TruncatedNormal

    def init(self, loc, scale, device) -> dict:
        return _raw(loc, scale, self.scale_shift, device)

    def distribution(self, params: dict) -> TruncatedNormal:
        return TruncatedNormal(
            loc=torch.exp(params["loc_raw"]),
            scale=torch.exp(params["scale_raw"]) + self.scale_shift,
            low=self.low, high=self.high)


@dataclass(frozen=True, eq=False)
class RiceWoolfsonPosterior:
    """FoldedNormal (Woolfson) for centric reflections, Rice for acentric
    ones (surrogate.py:57-78); centric is the (n_refl,) bool flag."""

    centric: Optional[torch.Tensor] = None
    scale_shift: float = 1e-7
    family: ClassVar[type] = RiceWoolfson

    def init(self, loc, scale, device) -> dict:
        return _raw(loc, scale, self.scale_shift, device)

    def distribution(self, params: dict) -> RiceWoolfson:
        return RiceWoolfson(
            loc=torch.exp(params["loc_raw"]),
            scale=torch.exp(params["scale_raw"]) + self.scale_shift,
            centric=self.centric)
