"""The port's distributions against careless_tpu.ops.distributions.

Same float32 inputs on both sides. Tolerances: closed forms agree to a few
f32 ulp (rtol 1e-5); where a tail makes a quantity a difference of nearly
equal terms (log Z and the moments far in a tail) the two special-function
libraries' last-ulp differences are amplified, so those use rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.ops import distributions as jd
from careless_tpu_torch.ops import distributions as td

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_normal():
    rng = np.random.default_rng(0)
    loc = rng.normal(size=50).astype(np.float32)
    scale = rng.uniform(0.1, 3, 50).astype(np.float32)
    x = rng.normal(size=50).astype(np.float32) * 3
    j, t = jd.Normal(loc, scale), td.Normal(_t(loc), _t(scale))
    _close(t.log_prob(_t(x)), j.log_prob(x))
    _close(t.mean(), j.mean())
    _close(t.stddev(), j.stddev())


def test_half_normal_and_weibull():
    rng = np.random.default_rng(1)
    lam = rng.uniform(0.2, 3, 40).astype(np.float32)
    x = rng.uniform(0.01, 5, 40).astype(np.float32)
    for j, t in ((jd.HalfNormal(lam), td.HalfNormal(_t(lam))),
                 (jd.Weibull(2.0, lam), td.Weibull(2.0, _t(lam)))):
        _close(t.log_prob(_t(x)), j.log_prob(x))
        _close(t.mean(), j.mean())
        _close(t.stddev(), j.stddev())


# loc, scale, low: interior, the acentric 1e-32 bound with a narrow scale
# (alpha << 0, erf saturates at -1), and the far upper tail (alpha >> 0)
TN_CASES = [
    (np.linspace(0.5, 3, 12), np.linspace(0.05, 2, 12), 0.0),
    (np.linspace(0.8, 1.5, 12), np.full(12, 0.01), 1e-32),
    (np.full(12, -4.0), np.linspace(0.4, 0.6, 12), 0.0),
]


@pytest.mark.parametrize("loc,scale,low", TN_CASES)
def test_truncated_normal_closed_forms(loc, scale, low):
    loc, scale = loc.astype(np.float32), scale.astype(np.float32)
    low = np.full_like(loc, low)
    j = jd.TruncatedNormal(loc, scale, low, 1e10)
    t = td.TruncatedNormal(_t(loc), _t(scale), _t(low), 1e10)
    _close(t._log_z(), j._log_z(), rtol=1e-4)
    x = np.abs(loc) + scale
    _close(t.log_prob(_t(x)), j.log_prob(x), rtol=1e-4)
    for name in ("mean", "stddev", "variance", "moment_4", "entropy"):
        _close(getattr(t, name)(), getattr(j, name)(), rtol=1e-4, atol=1e-5)
    # outside the support
    assert torch.isneginf(t.log_prob(_t(low - 1.0))).all()


def test_truncated_normal_log_z_tails():
    """log Z matches in both tails: far below the bound (alpha = -12, none
    of the mass truncated) and above it up to alpha = 5, where log Z is
    -15. Past alpha ~ 5.5 both packages give -inf (exp(la - lb) rounds to
    1 in f32); the port keeps the JAX package's numbers there too."""
    loc = np.array([-12.0, -5.0, 3.0, 5.0, 12.0, -8.0], np.float32)
    j = jd.TruncatedNormal(-loc, np.ones(6, np.float32), 0.0, 1e10)
    t = td.TruncatedNormal(_t(-loc), _t(np.ones(6)), 0.0, 1e10)
    got = t._log_z()
    assert torch.isfinite(got[:4]).all()
    _close(got, j._log_z(), rtol=1e-4)


@pytest.mark.parametrize("low", [0.0, 1e-32])
def test_truncated_normal_sample_at_fixed_uniforms(low):
    """Same uniforms on both sides: jax.random.uniform(key) gives exactly
    the floats jax.random.truncated_normal(key) draws internally, so the
    samples, and their gradients in loc and scale through alpha and beta,
    must agree."""
    rng = np.random.default_rng(3)
    n = 300
    loc = rng.uniform(0.2, 3, n).astype(np.float32)
    scale = rng.uniform(0.01, 1.5, n).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    key = jax.random.PRNGKey(11)
    f = np.asarray(jax.random.uniform(key, (n,), jnp.float32))

    def jax_obj(loc, scale):
        z = jd.TruncatedNormal(loc, scale, low, 1e10).sample(key)
        return jnp.sum(z * w), z

    (_, z_j), (gl_j, gs_j) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(loc, scale)

    loc_t = _t(loc).requires_grad_(True)
    scale_t = _t(scale).requires_grad_(True)
    z = td.TruncatedNormal(loc_t, scale_t, low, 1e10).sample_from_uniform(
        torch.tensor(f))
    gl, gs = torch.autograd.grad((z * _t(w)).sum(), (loc_t, scale_t))
    _close(z, z_j, rtol=1e-5)
    _close(gl, gl_j, rtol=1e-4, atol=1e-5)
    _close(gs, gs_j, rtol=1e-4, atol=1e-5)
    assert (z.detach().numpy() >= low).all()


def test_truncated_normal_sample_moments():
    """Sampling with a torch.Generator reproduces the closed-form mean."""
    gen = torch.Generator().manual_seed(0)
    t = td.TruncatedNormal(_t([0.5, 2.0]), _t([1.0, 0.3]), 0.0, 1e10)
    z = t.sample(gen, (200_000,))
    torch.testing.assert_close(z.mean(0), t.mean(), rtol=0, atol=1e-2)
