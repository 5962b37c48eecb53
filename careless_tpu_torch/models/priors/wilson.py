"""Wilson prior on structure-factor amplitudes.

Counterpart of careless_tpu/models/priors/wilson.py:22-84. Centric
reflections: HalfNormal(sqrt(eps * Sigma)); acentric: Weibull(2,
sqrt(eps * Sigma)), a Rayleigh; selected elementwise by the centric flag.
expected_log_prob is the cross entropy of --analytic-kl; as_stacy gives
the same prior as one Stacy distribution, whose KL is analytic.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

import torch

from ...ops.distributions import HalfNormal, Stacy, Weibull


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

    def prob(self, x):
        return torch.exp(self.log_prob(x))

    def mean(self):
        pc, pa = self._parts()
        return torch.where(self.centric, pc.mean(), pa.mean())

    def stddev(self):
        pc, pa = self._parts()
        return torch.where(self.centric, pc.stddev(), pa.stddev())

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        """The centric and the acentric part each drawn for every entry
        (the centric first), then selected by the flag."""
        pc, pa = self._parts()
        return torch.where(self.centric, pc.sample(generator, sample_shape),
                           pa.sample(generator, sample_shape))

    def as_stacy(self) -> Stacy:
        """The same prior as a Stacy distribution (wilson.py:54-57)."""
        return Stacy.wilson_prior(
            torch.as_tensor(self.centric, dtype=torch.float32),
            self.epsilon, self.sigma)

    def expected_log_prob(self, q, z_samples):
        """E_q[log p(z)] with every expectation that has a closed form taken
        in it (wilson.py:59-84): centric, 0.5 log(2 / pi) - log l -
        E[z^2] / (2 l^2) from q.moment_2(); acentric, log 2 - 2 log l +
        E[log z] - E[z^2] / l^2, with E[log z] the mean over the leading MC
        axis of z_samples (when they have one) of log max(z, 1e-30);
        l^2 = eps Sigma."""
        lam2 = self.epsilon * self.sigma
        log_lam2 = torch.log(torch.as_tensor(lam2))
        ez2 = q.moment_2()
        centric_elp = (0.5 * math.log(2.0 / math.pi) - 0.5 * log_lam2
                       - 0.5 * ez2 / lam2)
        log_z = torch.log(torch.clamp(z_samples, min=1e-30))
        e_log_z = (torch.mean(log_z, dim=0) if z_samples.dim() > ez2.dim()
                   else log_z)
        acentric_elp = math.log(2.0) - log_lam2 + e_log_z - ez2 / lam2
        return torch.where(self.centric, centric_elp, acentric_elp)
