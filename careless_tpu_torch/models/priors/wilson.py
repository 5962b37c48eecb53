"""Wilson prior on structure-factor amplitudes.

Counterpart of careless_tpu/models/priors/wilson.py:22-52. Centric
reflections: HalfNormal(sqrt(eps * Sigma)); acentric: Weibull(2,
sqrt(eps * Sigma)), a Rayleigh; selected elementwise by the centric flag.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ...ops.distributions import HalfNormal, Weibull


class WilsonPrior(NamedTuple):
    centric: torch.Tensor                # (n_refl,) bool
    epsilon: torch.Tensor                # (n_refl,) f32 multiplicity
    sigma: Union[torch.Tensor, float] = 1.0  # Sigma, scalar or per reflection

    def _parts(self):
        lam = torch.sqrt(self.epsilon * self.sigma)
        return HalfNormal(lam), Weibull(2.0, lam)

    def log_prob(self, x):
        pc, pa = self._parts()
        return torch.where(self.centric, pc.log_prob(x), pa.log_prob(x))

    def mean(self):
        pc, pa = self._parts()
        return torch.where(self.centric, pc.mean(), pa.mean())

    def stddev(self):
        pc, pa = self._parts()
        return torch.where(self.centric, pc.stddev(), pa.stddev())
