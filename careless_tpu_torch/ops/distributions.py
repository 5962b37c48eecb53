"""Probability distributions on tensors.

Counterpart of careless_tpu/ops/distributions.py, class for class (Normal,
Laplace, StudentT, HalfNormal, Weibull, Gamma, Exponential,
TruncatedNormal, FoldedNormal, Rice, Amoroso, Stacy, RiceWoolfson), with
the same formulas, so that at equal inputs the two packages agree to f32
rounding. `sample(generator, sample_shape)` takes an explicit
torch.Generator; its draws are not jax.random's. The surrogate posteriors
(TruncatedNormal, RiceWoolfson) own their draw in two parts:
draw_noise(generator, shape, device) takes the standard noise from the
generator (uniforms for the truncated normal, normals for RiceWoolfson)
and sample_from_noise turns given noise into the sample, by the route of
the JAX package's sample, which is how the tests hold them against JAX.
FoldedNormal and Rice also sample from given normals.
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


def _shape(sample_shape, t: torch.Tensor):
    return tuple(sample_shape) + tuple(t.shape)


def _randn(generator, shape, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _rand(generator, shape, device):
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _gamma(generator, concentration: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gamma(concentration) draws of `shape`; differentiable in
    the concentration through the implicit gradient, as jax.random.gamma
    is."""
    return torch._standard_gamma(concentration.expand(shape).contiguous(),
                                 generator=generator)


class Normal(NamedTuple):
    loc: Numeric
    scale: Numeric

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        loc, scale = _bcast(self.loc, self.scale)
        return loc + scale * _randn(generator, _shape(sample_shape, loc),
                                    loc.device)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(torch.as_tensor(self.scale)) \
            - 0.5 * _LOG_2PI

    def mean(self):
        return torch.as_tensor(self.loc)

    def stddev(self):
        return torch.as_tensor(self.scale)

    def variance(self):
        return torch.square(torch.as_tensor(self.scale))

    def kl_divergence(self, other: "Normal"):
        """KL(self || other), analytic."""
        var_ratio = torch.square(torch.as_tensor(self.scale) / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it, logaddexp(0, x):
    max(x, 0) + log1p(exp(-|x|)) with no threshold, and the derivative 1/2
    at x = 0."""
    return torch.logaddexp(torch.zeros_like(x), x)


class Laplace(NamedTuple):
    loc: Numeric
    scale: Numeric

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        """loc + scale * Laplace(0, 1) by jax.random.laplace's inverse CDF:
        u uniform in [-1 + epsneg, 1), -sign(u) log1p(-|u|)."""
        loc, scale = _bcast(self.loc, self.scale)
        epsneg = float(np.finfo(np.float32).epsneg)
        u = _rand(generator, _shape(sample_shape, loc), loc.device) \
            * (2.0 - epsneg) - (1.0 - epsneg)
        return loc - scale * torch.sign(u) * torch.log1p(-torch.abs(u))

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

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        """loc + scale * n / sqrt(2 g / df), n standard normal and
        g ~ Gamma(df / 2): a t variate with df degrees of freedom."""
        df, loc, scale = _bcast(self.df, self.loc, self.scale)
        shape = _shape(sample_shape, loc)
        n = _randn(generator, shape, loc.device)
        g = _gamma(generator, 0.5 * df, shape)
        return loc + scale * n * torch.rsqrt(2.0 * g / df)

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

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        (scale,) = _bcast(self.scale)
        return scale * torch.abs(_randn(generator, _shape(sample_shape, scale),
                                        scale.device))

    def log_prob(self, x):
        z = x / self.scale
        return (0.5 * math.log(2.0 / math.pi)
                - torch.log(torch.as_tensor(self.scale)) - 0.5 * z * z)

    def mean(self):
        return torch.as_tensor(self.scale) * _SQRT_2_OVER_PI

    def stddev(self):
        return torch.as_tensor(self.scale) * math.sqrt(1.0 - 2.0 / math.pi)

    def variance(self):
        return torch.square(torch.as_tensor(self.scale)) \
            * (1.0 - 2.0 / math.pi)


class Weibull(NamedTuple):
    concentration: Numeric  # k
    scale: Numeric          # lambda

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        """lam (-log u)^(1 / k), u uniform in [tiny, 1)."""
        k, lam = _bcast(self.concentration, self.scale)
        u = torch.clamp(_rand(generator, _shape(sample_shape, lam),
                              lam.device),
                        min=float(np.finfo(np.float32).tiny))
        return lam * torch.pow(-torch.log(u), 1.0 / k)

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


class Gamma(NamedTuple):
    concentration: Numeric
    rate: Numeric = 1.0

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        conc, rate = _bcast(self.concentration, self.rate)
        return _gamma(generator, conc, _shape(sample_shape, conc)) / rate

    def log_prob(self, x):
        conc, rate = _bcast(self.concentration, self.rate)
        return (conc * torch.log(rate) + (conc - 1.0) * torch.log(x)
                - rate * x - torch.lgamma(conc))


class Exponential(NamedTuple):
    rate: Numeric

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        (rate,) = _bcast(self.rate)
        e = torch.empty(_shape(sample_shape, rate), dtype=torch.float32,
                        device=rate.device).exponential_(generator=generator)
        return e / rate

    def log_prob(self, x):
        (rate,) = _bcast(self.rate)
        return torch.log(rate) - rate * x


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

    @staticmethod
    def noise_shape(shape: Sequence[int]) -> tuple:
        """The shape of the noise behind samples of `shape`."""
        return tuple(shape)

    @staticmethod
    def draw_noise(generator: torch.Generator, shape: Sequence[int],
                   device) -> torch.Tensor:
        """Standard uniforms in [0, 1) of `shape`, the sample's shape."""
        return _rand(generator, tuple(shape), device)

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return self.sample_from_uniform(noise)

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        loc, *_ = _bcast(self.loc, self.scale, self.low, self.high)
        return self.sample_from_uniform(self.draw_noise(
            generator, _shape(sample_shape, loc), loc.device))

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

    def sample_from_normal(self, n: torch.Tensor) -> torch.Tensor:
        """|loc + scale n| at standard normals n (the JAX sample's route)."""
        loc, scale = _bcast(self.loc, self.scale)
        return torch.abs(loc + scale * n)

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        loc, _ = _bcast(self.loc, self.scale)
        return self.sample_from_normal(_randn(
            generator, _shape(sample_shape, loc), loc.device))

    def log_prob(self, x):
        loc, scale = self.loc, self.scale
        z1 = (x - loc) / scale
        z2 = (x + loc) / scale
        lp = torch.logaddexp(-0.5 * z1 * z1, -0.5 * z2 * z2)
        lp = lp - 0.5 * _LOG_2PI - torch.log(torch.as_tensor(scale))
        return torch.where(x < 0, torch.full_like(lp, float("nan")), lp)

    def prob(self, x):
        p = torch.exp(self.log_prob(torch.clamp(x, min=0.0)))
        return torch.where(x < 0, torch.zeros_like(p), p)

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

    def sample_from_normals(self, n1: torch.Tensor,
                            n2: torch.Tensor) -> torch.Tensor:
        """sqrt((sigma n1)^2 + (sigma n2 + nu)^2) at standard normals n1,
        n2 (the JAX sample's route, n1 and n2 from the two halves of its
        split key)."""
        nu, sigma = _bcast(self.nu, self.sigma)
        s1 = sigma * n1
        s2 = sigma * n2
        return torch.sqrt(s1 * s1 + torch.square(s2 + nu))

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        nu, _ = _bcast(self.nu, self.sigma)
        shape = _shape(sample_shape, nu)
        n1 = _randn(generator, shape, nu.device)
        return self.sample_from_normals(n1, _randn(generator, shape,
                                                   nu.device))

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


class Amoroso(NamedTuple):
    """The Amoroso (generalized gamma) distribution in Crooks'
    parameterization (distributions.py:372-407)."""

    a: Numeric
    theta: Numeric
    alpha: Numeric
    beta: Numeric

    def log_prob(self, x):
        a, theta, alpha, beta = _bcast(self.a, self.theta, self.alpha,
                                       self.beta)
        z = (x - a) / theta
        return (torch.log(torch.abs(beta / theta)) - torch.lgamma(alpha)
                + (alpha * beta - 1.0) * torch.log(z) - torch.pow(z, beta))

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        """a + theta g^(1 / beta), g ~ Gamma(alpha)."""
        a, theta, alpha, beta = _bcast(self.a, self.theta, self.alpha,
                                       self.beta)
        g = _gamma(generator, alpha, _shape(sample_shape, alpha))
        return a + theta * torch.pow(g, 1.0 / beta)

    def mean(self):
        a, theta, alpha, beta = _bcast(self.a, self.theta, self.alpha,
                                       self.beta)
        return a + torch.exp(torch.log(theta) + torch.lgamma(alpha + 1.0 / beta)
                             - torch.lgamma(alpha))

    def variance(self):
        _, theta, alpha, beta = _bcast(self.a, self.theta, self.alpha,
                                       self.beta)
        lg = torch.lgamma(alpha)
        return torch.square(theta) * (
            torch.exp(torch.lgamma(alpha + 2.0 / beta) - lg)
            - torch.exp(2.0 * torch.lgamma(alpha + 1.0 / beta) - 2.0 * lg))

    def stddev(self):
        return torch.sqrt(self.variance())


class Stacy(NamedTuple):
    """Stacy: Amoroso with a = 0, with Bauckhage's analytic KL
    (distributions.py:410-471)."""

    theta: Numeric
    alpha: Numeric
    beta: Numeric

    def _amoroso(self) -> Amoroso:
        return Amoroso(0.0, self.theta, self.alpha, self.beta)

    def log_prob(self, x):
        return self._amoroso().log_prob(x)

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        return self._amoroso().sample(generator, sample_shape)

    def mean(self):
        return self._amoroso().mean()

    def variance(self):
        return self._amoroso().variance()

    def stddev(self):
        return self._amoroso().stddev()

    @classmethod
    def wilson_prior(cls, centric, epsilon, sigma=1.0) -> "Stacy":
        """The Wilson prior as a Stacy distribution: centric
        HalfNormal(sqrt(eps Sigma)) = Stacy(sqrt(2 eps Sigma), 1/2, 2),
        acentric Rayleigh = Stacy(sqrt(eps Sigma), 1, 2)."""
        device = next((x.device for x in (centric, epsilon, sigma)
                       if isinstance(x, torch.Tensor)), None)
        centric, epsilon, sigma = (
            torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (centric, epsilon, sigma))
        theta = (centric * torch.sqrt(2.0 * epsilon * sigma)
                 + (1.0 - centric) * torch.sqrt(epsilon * sigma))
        alpha = centric * 0.5 + (1.0 - centric)
        return cls(theta, alpha, torch.full_like(theta, 2.0))

    @staticmethod
    def from_half_normal(scale) -> "Stacy":
        return Stacy(_SQRT2_F32 * torch.as_tensor(scale, dtype=torch.float32),
                     0.5, 2.0)

    @staticmethod
    def from_weibull(concentration, scale) -> "Stacy":
        return Stacy(torch.as_tensor(scale, dtype=torch.float32), 1.0,
                     torch.as_tensor(concentration, dtype=torch.float32))

    def _bauckhage(self):
        theta, alpha, beta = _bcast(self.theta, self.alpha, self.beta)
        return theta, alpha * beta, beta

    def kl_divergence(self, other: "Stacy"):
        """KL(self || other), Bauckhage 2014 (arXiv:1401.6853)."""
        a1, d1, p1 = self._bauckhage()
        a2, d2, p2 = other._bauckhage()
        ln, lg = torch.log, torch.lgamma
        return (ln(p1) + d2 * ln(a2) + lg(d2 / p2)
                - ln(p2) - d1 * ln(a1) - lg(d1 / p1)
                + (torch.digamma(d1 / p1) / p1 + ln(a1)) * (d1 - d2)
                + torch.exp(lg((d1 + p2) / p1) - lg(d1 / p1)
                            + p2 * (ln(a1) - ln(a2)))
                - d1 / p1)


class RiceWoolfson(NamedTuple):
    """FoldedNormal (Woolfson) for centric reflections, Rice for acentric
    ones (distributions.py:474-504)."""

    loc: Numeric
    scale: Numeric
    centric: torch.Tensor  # bool

    def _parts(self):
        return FoldedNormal(self.loc, self.scale), Rice(self.loc, self.scale)

    @staticmethod
    def noise_shape(shape: Sequence[int]) -> tuple:
        """The shape of the noise behind samples of `shape`: three standard
        normals per entry."""
        return (3,) + tuple(shape)

    @classmethod
    def draw_noise(cls, generator: torch.Generator, shape: Sequence[int],
                   device) -> torch.Tensor:
        """Standard normals of noise_shape(shape): [0] for the centric
        (FoldedNormal) sample, [1] and [2] for the acentric (Rice) one."""
        return _randn(generator, cls.noise_shape(shape), device)

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        """The JAX sample at given normals: JAX's RiceWoolfson.sample(key)
        takes the centric draw from normal(key) and Rice's two from
        normal(k1) and normal(k2), (k1, k2) = split(key); the centric
        sample is shifted up by f32 eps, as there."""
        w, r = self._parts()
        eps = float(np.finfo(np.float32).eps)
        return torch.where(self.centric, w.sample_from_normal(noise[0]) + eps,
                           r.sample_from_normals(noise[1], noise[2]))

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> torch.Tensor:
        loc, *_ = _bcast(self.loc, self.scale)
        return self.sample_from_noise(self.draw_noise(
            generator, _shape(sample_shape, loc), loc.device))

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
