"""The port's Laplace and StudentT distributions and its mono likelihoods
against careless_tpu's.

Same float32 inputs on both sides; rtol 1e-5 (f32 closed forms: lgamma,
log1p, softplus, sqrt), and the Ev11 raw parameters' gradients, sums over
900 observations, at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods import mono as jmono
from careless_tpu.ops import distributions as jd
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import mono
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.ops import distributions as td
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _arrays(n=900, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n), rng.integers(0, 5, n), np.zeros(n),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.gamma(2.0, 1.0, n).astype(np.float32),
            rng.uniform(0.1, 0.5, n).astype(np.float32))


def test_laplace():
    rng = np.random.default_rng(0)
    loc = rng.normal(size=60).astype(np.float32)
    scale = rng.uniform(0.1, 3, 60).astype(np.float32)
    x = (rng.normal(size=60) * 3).astype(np.float32)
    j, t = jd.Laplace(loc, scale), td.Laplace(_t(loc), _t(scale))
    _close(t.log_prob(_t(x)), j.log_prob(x))
    _close(t.mean(), j.mean())
    _close(t.stddev(), j.stddev())


# (at large df, lgamma(df / 2 + 1 / 2) - lgamma(df / 2) cancels in f32 in
# both packages, and their lgammas differ by an ulp of lgamma's value)
@pytest.mark.parametrize("df", [1.0, 4.0, 16.0])
def test_student_t(df):
    rng = np.random.default_rng(1)
    loc = rng.normal(size=60).astype(np.float32)
    scale = rng.uniform(0.1, 3, 60).astype(np.float32)
    x = (rng.normal(size=60) * 5).astype(np.float32)
    j, t = jd.StudentT(df, loc, scale), td.StudentT(df, _t(loc), _t(scale))
    _close(t.log_prob(_t(x)), j.log_prob(x))
    _close(t.mean(), j.mean())


def test_softplus_is_jax_softplus():
    x = np.array([-200, -30, -5, -1e-3, 0, 1e-3, 5, 19.9, 20.1, 30, 200],
                 np.float32)
    _close(td.softplus(_t(x)), jax.nn.softplus(x), rtol=1e-6, atol=0)


def test_softplus_gradient_is_jax_softplus():
    """Including x = 0, where the derivative is 1/2 (a prediction that is
    exactly 0 reaches the Ev11 softplus on the Laue path's padding tail)."""
    x = np.array([-30, -1, 0, 1e-3, 1, 25], np.float32)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(td.softplus(xt).sum(), xt)
    _close(g, jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(x),
           rtol=1e-6, atol=0)
    assert g[2].item() == 0.5


LIKELIHOODS = [
    (jmono.NormalLikelihood(), mono.NormalLikelihood()),
    (jmono.LaplaceLikelihood(), mono.LaplaceLikelihood()),
    (jmono.StudentTLikelihood(4.0), mono.StudentTLikelihood(4.0)),
    (jmono.NormalEv11Likelihood(), mono.NormalEv11Likelihood()),
    (jmono.StudentTEv11Likelihood(6.0), mono.StudentTEv11Likelihood(6.0)),
]


@pytest.mark.parametrize("j_lik,t_lik", LIKELIHOODS,
                         ids=lambda x: type(x).__name__)
def test_likelihood_log_prob(j_lik, t_lik):
    arrays = _arrays()
    rng = np.random.default_rng(2)
    # predictions of both signs and far from the data, where softplus and
    # the heavy tails matter
    ipred = (rng.gamma(2.0, 1.0, 900) * rng.choice([-3.0, 1.0, 4.0], 900)
             ).astype(np.float32)
    j_params = j_lik.init()
    t_params = t_lik.init("cpu")
    assert set(t_params) == set(j_params)
    for k, v in t_params.items():   # softplus^-1(1), as 0-d leaves
        assert v.shape == () and v.item() == float(j_params[k])
    j_params = {k: np.float32(v) + np.float32(0.1 * i)
                for i, (k, v) in enumerate(sorted(j_params.items()))}
    j = j_lik.build(j_params, JInputs.from_arrays(*arrays))
    t = t_lik.build(params_from_jax(j_params, "cpu"),
                    Inputs.from_arrays(*arrays, device="cpu"))
    _close(t.log_prob(_t(ipred)), j.log_prob(ipred))
    _close(t.mean(), j.mean())
    if hasattr(j, "stddev"):
        _close(t.stddev(), j.stddev())


@pytest.mark.parametrize("j_lik,t_lik", LIKELIHOODS[3:],
                         ids=lambda x: type(x).__name__)
def test_ev11_raw_parameter_gradients(j_lik, t_lik):
    arrays = _arrays(seed=3)
    ipred = np.random.default_rng(4).gamma(2.0, 1.0, 900).astype(np.float32)
    j_in = JInputs.from_arrays(*arrays)
    want = jax.grad(lambda p: jnp.sum(
        j_lik.build(p, j_in).log_prob(ipred)))(j_lik.init())
    params = t_lik.init("cpu")
    for v in params.values():
        v.requires_grad_(True)
    ll = t_lik.build(params, Inputs.from_arrays(*arrays, device="cpu")
                     ).log_prob(_t(ipred)).sum()
    keys = sorted(params)
    grads = torch.autograd.grad(ll, [params[k] for k in keys])
    for k, g in zip(keys, grads):
        _close(g, want[k], rtol=1e-4)


def test_likelihood_params_round_trip_in_pytree_order():
    """params_from_jax / params_to_numpy carry the 0-d likelihood leaves,
    and flatten_params lists them in jax.tree.leaves order."""
    rng = np.random.default_rng(5)
    tree = {"likelihood": {k: np.float32(rng.normal()) for k in
                           ("sdfac_raw", "sdb_raw", "sdadd_raw")},
            "posterior": {"loc_raw": rng.normal(size=4).astype(np.float32),
                          "scale_raw": rng.normal(size=4).astype(np.float32)},
            "scaler": {"image": {"scales": np.ones(2, np.float32)}}}
    p = params_from_jax(tree, "cpu")
    assert all(v.shape == () for v in p["likelihood"].values())
    named = flatten_params(p)
    assert [t.item() if t.dim() == 0 else t.tolist() for _, t in named] == [
        np.asarray(x).tolist() for x in jax.tree.leaves(tree)]
    back = params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
