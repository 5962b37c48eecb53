"""Reference priors centred on external amplitudes.

Counterpart of careless_tpu/models/priors/empirical.py (not wired to the
CLI there either). The reflections that an external file holds get the
log-probability of a location-scale family centred on its Fobs; the
others contribute 0, and their mean is 1.

As in the JAX package, the unselected branch of the select is computed
too: where an unobserved entry's loc or scale is garbage (0, inf, NaN)
its log-probability is NaN or inf before the select, and torch.where,
like jnp.where, passes the NaN of that branch's derivative times the
zero cotangent on to x. The port keeps those numbers; a caller that fills
unobserved entries with finite values gets finite gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops.distributions import Laplace, Normal, RiceWoolfson, StudentT


@dataclass(frozen=True, eq=False)
class ReferencePrior:
    """observed: (n_refl,) bool, True where the external file has a datum;
    loc, scale: (n_refl,) f32 Fobs and SigFobs (garbage where unobserved);
    kind: "normal", "laplace", "studentt" (with dof) or "ricewoolfson"
    (with centric, (n_refl,) bool). No trainable parameters."""

    observed: torch.Tensor
    loc: torch.Tensor
    scale: torch.Tensor
    kind: str = "normal"
    dof: Optional[float] = None
    centric: Optional[torch.Tensor] = None

    def _dist(self):
        if self.kind == "normal":
            return Normal(self.loc, self.scale)
        if self.kind == "laplace":
            return Laplace(self.loc, self.scale)
        if self.kind == "studentt":
            return StudentT(self.dof, self.loc, self.scale)
        if self.kind == "ricewoolfson":
            return RiceWoolfson(self.loc, self.scale, self.centric)
        raise ValueError(f"unknown reference prior kind {self.kind!r}")

    def log_prob(self, x):
        lp = self._dist().log_prob(x)
        return torch.where(self.observed, lp, torch.zeros_like(lp))

    def mean(self):
        m = self._dist().mean()
        return torch.where(self.observed, m, torch.ones_like(m))
