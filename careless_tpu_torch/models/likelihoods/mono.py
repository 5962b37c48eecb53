"""Likelihoods for monochromatic data.

Counterpart of careless_tpu/models/likelihoods/mono.py:28-35 (the Normal
likelihood). StudentT, Laplace and the Ev11 variants are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...ops.distributions import Normal
from ..base import Inputs


@dataclass(frozen=True)
class NormalLikelihood:
    def init(self) -> dict:
        return {}

    def build(self, params: dict, inputs: Inputs) -> Normal:
        return Normal(inputs.intensities, inputs.uncertainties)
