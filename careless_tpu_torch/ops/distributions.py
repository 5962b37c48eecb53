"""Probability distributions on tensors: the pieces the mono merge uses.

Counterpart of careless_tpu/ops/distributions.py (Normal, Laplace, StudentT,
TruncatedNormal, HalfNormal, Weibull, and for the double-Wilson prior
FoldedNormal, Rice and RiceWoolfson), with the same formulas, so that at
equal inputs the two packages agree to f32 rounding. Sampling takes an
explicit torch.Generator; TruncatedNormal can also be sampled from given
standard uniforms, which is how the tests hold it against JAX. Only what
the merge's ELBO, its priors and DataManager use is here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

Numeric = Union[torch.Tensor, float]

_LOG_2PI = float(np.float32(math.log(2.0 * math.pi)))
_SQRT_2_OVER_PI = 0.7978845608028654
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))


def _bcast(*xs):
    """Broadcast to float32 tensors on the device of the first tensor."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                  None)
    return torch.broadcast_tensors(*[
        torch.as_tensor(x, dtype=torch.float32, device=device) for x in xs])


class Normal(NamedTuple):
    loc: Numeric
    scale: Numeric

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(torch.as_tensor(self.scale)) \
            - 0.5 * _LOG_2PI

    def mean(self):
        return torch.as_tensor(self.loc)

    def stddev(self):
        return torch.as_tensor(self.scale)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it, logaddexp(0, x):
    max(x, 0) + log1p(exp(-|x|)) with no threshold, and the derivative 1/2
    at x = 0."""
    return torch.logaddexp(torch.zeros_like(x), x)


class Laplace(NamedTuple):
    loc: Numeric
    scale: Numeric

    def log_prob(self, x):
        return (-torch.abs(x - self.loc) / self.scale
                - torch.log(2.0 * torch.as_tensor(self.scale)))

    def mean(self):
        return torch.as_tensor(self.loc)

    def stddev(self):
        return _SQRT2_F32 * torch.as_tensor(self.scale)


class StudentT(NamedTuple):
    df: Numeric
    loc: Numeric
    scale: Numeric

    def log_prob(self, x):
        df = torch.as_tensor(self.df, dtype=torch.float32)
        z = (x - self.loc) / self.scale
        lognorm = (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                   - 0.5 * torch.log(df * math.pi)
                   - torch.log(torch.as_tensor(self.scale)))
        return lognorm - 0.5 * (df + 1.0) * torch.log1p(z * z / df)

    def mean(self):
        return torch.as_tensor(self.loc)


class HalfNormal(NamedTuple):
    scale: Numeric

    def log_prob(self, x):
        z = x / self.scale
        return (0.5 * math.log(2.0 / math.pi)
                - torch.log(torch.as_tensor(self.scale)) - 0.5 * z * z)

    def mean(self):
        return torch.as_tensor(self.scale) * _SQRT_2_OVER_PI

    def stddev(self):
        return torch.as_tensor(self.scale) * math.sqrt(1.0 - 2.0 / math.pi)


class Weibull(NamedTuple):
    concentration: Numeric  # k
    scale: Numeric          # lambda

    def log_prob(self, x):
        k, lam = _bcast(self.concentration, self.scale)
        logx = torch.log(x)
        log_lam = torch.log(lam)
        return (torch.log(k) - log_lam + (k - 1.0) * (logx - log_lam)
                - torch.exp(k * (logx - log_lam)))

    def mean(self):
        k, lam = _bcast(self.concentration, self.scale)
        return lam * torch.exp(torch.lgamma(1.0 + 1.0 / k))

    def variance(self):
        k, lam = _bcast(self.concentration, self.scale)
        return torch.square(lam) * (torch.exp(torch.lgamma(1.0 + 2.0 / k))
                                    - torch.exp(2.0 * torch.lgamma(1.0 + 1.0 / k)))

    def stddev(self):
        return torch.sqrt(self.variance())


class TruncatedNormal(NamedTuple):
    """Normal(loc, scale) truncated to [low, high]: the surrogate posterior
    over |F| (careless_tpu/ops/distributions.py:185-280)."""

    loc: Numeric
    scale: Numeric
    low: Numeric = 0.0
    high: Numeric = 1e10

    def _alpha_beta(self):
        loc, scale, low, high = _bcast(self.loc, self.scale, self.low,
                                       self.high)
        return (low - loc) / scale, (high - loc) / scale

    def _log_z(self):
        """log(ndtr(beta) - ndtr(alpha)) by the JAX package's formula:
        accurate far below the bound; above it, finite up to alpha ~ 5.5,
        where exp(la - lb) rounds to 1 in f32 and the result is -inf."""
        alpha, beta = self._alpha_beta()
        la = torch.special.log_ndtr(alpha)
        lb = torch.special.log_ndtr(beta)
        return lb + torch.log1p(-torch.exp(torch.clamp(la - lb, max=-1e-20)))

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        loc, *_ = _bcast(self.loc, self.scale, self.low, self.high)
        u = torch.rand(tuple(sample_shape) + loc.shape, generator=generator,
                       device=loc.device, dtype=loc.dtype)
        return self.sample_from_uniform(u)

    def sample_from_uniform(self, f: torch.Tensor) -> torch.Tensor:
        """The sample at standard uniforms f in [0, 1), by the route of
        jax.random.truncated_normal: u = max(a, a + f (b - a)) with
        a = erf(alpha / sqrt 2), b = erf(beta / sqrt 2); s = sqrt 2 erfinv(u)
        clipped to the open interval (alpha, beta) with bounds that carry no
        gradient; then max(low, loc + scale s). Differentiable in loc and
        scale through alpha, beta and the final affine map."""
        loc, scale, low, _ = _bcast(self.loc, self.scale, self.low, self.high)
        alpha, beta = self._alpha_beta()
        a = torch.erf(alpha / _SQRT2_F32)
        b = torch.erf(beta / _SQRT2_F32)
        u = torch.maximum(a, f * (b - a) + a)
        s = _SQRT2_F32 * torch.erfinv(u)
        inf = torch.tensor(float("inf"), dtype=s.dtype, device=s.device)
        lo = torch.nextafter(alpha.detach(), inf)
        hi = torch.nextafter(beta.detach(), -inf)
        s = torch.minimum(torch.maximum(s, lo), hi)
        return torch.maximum(low, loc + scale * s)

    def log_prob(self, x):
        loc, scale, low, high = _bcast(self.loc, self.scale, self.low,
                                       self.high)
        z = (x - loc) / scale
        lp = -0.5 * z * z - 0.5 * _LOG_2PI - torch.log(scale) - self._log_z()
        return torch.where((x < low) | (x > high),
                           torch.full_like(lp, -float("inf")), lp)

    def _phi_terms(self):
        alpha, beta = self._alpha_beta()
        phi_a = torch.exp(-0.5 * alpha * alpha - 0.5 * _LOG_2PI)
        phi_b = torch.where(
            torch.isinf(beta), torch.zeros_like(beta),
            torch.exp(-0.5 * torch.clamp(beta, max=1e30) ** 2
                      - 0.5 * _LOG_2PI))
        return alpha, beta, phi_a, phi_b, torch.exp(self._log_z())

    def mean(self):
        loc, scale, *_ = _bcast(self.loc, self.scale, self.low, self.high)
        _, _, phi_a, phi_b, z = self._phi_terms()
        return loc + scale * (phi_a - phi_b) / z

    def _bterm(self, beta, phi_b):
        return torch.where(torch.isinf(beta), torch.zeros_like(beta),
                           torch.where(phi_b > 0, beta,
                                       torch.zeros_like(beta)) * phi_b)

    def variance(self):
        _, scale, *_ = _bcast(self.loc, self.scale, self.low, self.high)
        alpha, beta, phi_a, phi_b, z = self._phi_terms()
        frac = (alpha * phi_a - self._bterm(beta, phi_b)) / z
        tail = (phi_a - phi_b) / z
        return torch.square(scale) * (1.0 + frac - tail * tail)

    def stddev(self):
        return torch.sqrt(self.variance())

    def entropy(self):
        _, scale, *_ = _bcast(self.loc, self.scale, self.low, self.high)
        alpha, beta, phi_a, phi_b, z = self._phi_terms()
        return (0.5 * (_LOG_2PI + 1.0) + torch.log(scale) + self._log_z()
                + (alpha * phi_a - self._bterm(beta, phi_b)) / (2.0 * z))

    def moment_2(self):
        """Second raw moment E[X^2]."""
        return self.variance() + torch.square(self.mean())

    def moment_4(self):
        """Fourth raw moment E[X^4] (Orjebin's recurrence), inf-safe."""
        mu, sig, a, b = _bcast(self.loc, self.scale, self.low, self.high)
        _, _, phi_a, phi_b, z = self._phi_terms()
        aterm = (a * a * a + a * a * mu + a * mu * mu
                 + sig * sig * (3 * a + 5 * mu) + mu * mu * mu) * phi_a
        b_inf = torch.isinf(b)
        b_safe = torch.where(b_inf, torch.zeros_like(b), b)
        bterm = torch.where(
            b_inf, torch.zeros_like(b),
            (b_safe ** 3 + b_safe ** 2 * mu + b_safe * mu * mu
             + sig * sig * (3 * b_safe + 5 * mu) + mu ** 3) * phi_b)
        return (mu ** 4 + 6 * mu ** 2 * sig ** 2 + 3 * sig ** 4
                - sig * (bterm - aterm) / z)


class FoldedNormal(NamedTuple):
    """|X| for X ~ Normal(loc, scale) (distributions.py:283-316)."""

    loc: Numeric
    scale: Numeric

    def log_prob(self, x):
        loc, scale = self.loc, self.scale
        z1 = (x - loc) / scale
        z2 = (x + loc) / scale
        lp = torch.logaddexp(-0.5 * z1 * z1, -0.5 * z2 * z2)
        lp = lp - 0.5 * _LOG_2PI - torch.log(torch.as_tensor(scale))
        return torch.where(x < 0, torch.full_like(lp, float("nan")), lp)

    def mean(self):
        u, s = _bcast(self.loc, self.scale)
        return (s * _SQRT_2_OVER_PI * torch.exp(-0.5 * (u / s) ** 2)
                + u * (1.0 - 2.0 * torch.special.ndtr(-u / s)))

    def variance(self):
        u, s = _bcast(self.loc, self.scale)
        return u * u + s * s - torch.square(self.mean())

    def stddev(self):
        return torch.sqrt(self.variance())


def _log_i0(x):
    """log I0(x) from the exponentially scaled i0e(x) = I0(x) exp(-|x|)."""
    return torch.log(torch.special.i0e(x)) + torch.abs(x)


class Rice(NamedTuple):
    """The Rice distribution, with log-space Bessels and the normal
    crossover at nu / sigma > 40 (distributions.py:319-369)."""

    nu: Numeric
    sigma: Numeric

    _NORMAL_CROSSOVER = 40.0

    @staticmethod
    def _laguerre_half(x):
        """L_{1/2}(x) for x <= 0, by exponentially scaled Bessels."""
        h, ah = -0.5 * x, torch.abs(0.5 * x)
        return ((1.0 - x) * torch.exp(
                    x / 2.0 + torch.log(torch.special.i0e(h)) + ah)
                - x * torch.exp(x / 2.0 + torch.log(torch.special.i1e(h))
                                + ah))

    def log_prob(self, x):
        nu, sigma = self.nu, self.sigma
        return (torch.log(x) - 2.0 * torch.log(torch.as_tensor(sigma))
                - (x * x + nu * nu) / (2.0 * sigma * sigma)
                + _log_i0(x * nu / (sigma * sigma)))

    def mean(self):
        nu, sigma = _bcast(self.nu, self.sigma)
        snr = nu / sigma
        m = sigma * math.sqrt(math.pi / 2.0) * self._laguerre_half(
            -0.5 * snr * snr)
        return torch.where(snr > self._NORMAL_CROSSOVER, nu, m)

    def variance(self):
        nu, sigma = _bcast(self.nu, self.sigma)
        snr = nu / sigma
        lag = self._laguerre_half(-0.5 * snr * snr)
        v = (2.0 * sigma * sigma + nu * nu
             - 0.5 * math.pi * sigma * sigma * lag * lag)
        return torch.where(snr > self._NORMAL_CROSSOVER, sigma * sigma, v)

    def stddev(self):
        return torch.sqrt(self.variance())


class RiceWoolfson(NamedTuple):
    """FoldedNormal (Woolfson) for centric reflections, Rice for acentric
    ones (distributions.py:474-504)."""

    loc: Numeric
    scale: Numeric
    centric: torch.Tensor  # bool

    def _parts(self):
        return FoldedNormal(self.loc, self.scale), Rice(self.loc, self.scale)

    def log_prob(self, x):
        w, r = self._parts()
        return torch.where(self.centric, w.log_prob(x), r.log_prob(x))

    def mean(self):
        w, r = self._parts()
        return torch.where(self.centric, w.mean(), r.mean())

    def variance(self):
        w, r = self._parts()
        return torch.where(self.centric, w.variance(), r.variance())

    def stddev(self):
        return torch.sqrt(self.variance())
