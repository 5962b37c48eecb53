"""The library-level model parts of the port against careless_tpu, on the
CPU: the distributions (every JAX class has a counterpart with its public
methods; Gamma, Exponential, Amoroso and Stacy, Stacy's Wilson form and
Bauckhage KL, WilsonPrior.as_stacy), RiceWoolfsonPosterior,
ReferencePrior and NeuralNormalLikelihood, alone and together in one
ELBO, three Adam steps and a resumed run.

Same float32 inputs on both sides. Tolerances: closed forms and their
gradients at rtol 1e-5 (f32 lgamma, digamma, log, exp in two libraries);
1e-4 where a quantity is a difference of nearly equal terms (a variance
as E[x^2] - E[x]^2, the KL's cancelling terms). Samples at given noise
within a few ulp (the JAX side may fuse a multiply-add), their gradients
at rtol 1e-4. Draws from a torch.Generator are not jax.random's, so
they are held to their closed-form moments at a fixed seed: the mean
within 5 standard errors, the variance within 3 %. The ELBO and Adam as
tests/test_torch_elbo.py holds them: the loss at rtol 1e-5, each
gradient within 1e-4 of its tensor's largest entry, parameters after
Adam within 1e-6.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods import mono as jmono
from careless_tpu.models.merging.surrogate import \
    RiceWoolfsonPosterior as JRWPost
from careless_tpu.models.merging.variational import Trainer as JTrainer
from careless_tpu.models.priors.empirical import ReferencePrior as JRef
from careless_tpu.models.priors.wilson import WilsonPrior as JWilson
from careless_tpu.models.scaling.image import HybridImageScaler as JHybrid
from careless_tpu.models.scaling.image import ImageScaler as JImage
from careless_tpu.models.scaling.nn import MLPScaler as JMLP
from careless_tpu.ops import distributions as jd
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import mono
from careless_tpu_torch.models.merging.surrogate import (
    RiceWoolfsonPosterior, TruncatedNormalPosterior)
from careless_tpu_torch.models.merging.variational import (
    Trainer, VariationalMergingModel, flatten_params)
from careless_tpu_torch.models.priors.empirical import ReferencePrior
from careless_tpu_torch.models.priors.wilson import WilsonPrior
from careless_tpu_torch.models.scaling.image import (HybridImageScaler,
                                                     ImageScaler)
from careless_tpu_torch.models.scaling.nn import MLPScaler
from careless_tpu_torch.ops import distributions as td
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy
from tests.test_torch_elbo import _problem

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _public(cls):
    return {n for n in dir(cls)
            if not n.startswith("_") and callable(getattr(cls, n))}


def test_every_jax_distribution_has_a_counterpart_with_its_methods():
    jclasses = {n: c for n, c in vars(jd).items()
                if inspect.isclass(c) and c.__module__ == jd.__name__}
    assert len(jclasses) == 13
    for name, jc in jclasses.items():
        tc = getattr(td, name)
        assert tc._fields == jc._fields, name
        missing = _public(jc) - _public(tc)
        assert not missing, (name, missing)
        assert "sample" in _public(tc)


# ------------------------------------------------------------ closed forms
RNG = np.random.default_rng(40)
N = 30
POS = [RNG.uniform(0.3, 3.0, N).astype(np.float32) for _ in range(8)]
X = RNG.uniform(0.2, 5.0, N).astype(np.float32)
CENTRIC = RNG.random(N) < 0.4


def _stacy(d, th, al, be):
    return d.Stacy(th, al, be)


# name -> (function of the distributions module d and the arrays, arrays,
# rtol)
CLOSED = {
    "gamma_log_prob": (lambda d, c, r, x: d.Gamma(c, r).log_prob(x),
                       (POS[0], POS[1], X), 1e-5),
    "exponential_log_prob": (lambda d, r, x: d.Exponential(r).log_prob(x),
                             (POS[0], X), 1e-5),
    "amoroso_log_prob": (lambda d, a, th, al, be, x: d.Amoroso(
        a, th, al, be).log_prob(x), (-POS[4], POS[0], POS[1], POS[2], X),
        1e-5),
    "amoroso_mean": (lambda d, a, th, al, be: d.Amoroso(
        a, th, al, be).mean(), (-POS[4], POS[0], POS[1], POS[2]), 1e-5),
    "amoroso_variance": (lambda d, a, th, al, be: d.Amoroso(
        a, th, al, be).variance(), (-POS[4], POS[0], POS[1], POS[2]), 1e-4),
    "amoroso_stddev": (lambda d, a, th, al, be: d.Amoroso(
        a, th, al, be).stddev(), (-POS[4], POS[0], POS[1], POS[2]), 1e-4),
    "stacy_log_prob": (lambda d, th, al, be, x: _stacy(
        d, th, al, be).log_prob(x), (POS[0], POS[1], POS[2], X), 1e-5),
    "stacy_mean": (lambda d, th, al, be: _stacy(d, th, al, be).mean(),
                   (POS[0], POS[1], POS[2]), 1e-5),
    "stacy_variance": (lambda d, th, al, be: _stacy(
        d, th, al, be).variance(), (POS[0], POS[1], POS[2]), 1e-4),
    "stacy_kl": (lambda d, t1, a1, b1, t2, a2, b2: _stacy(
        d, t1, a1, b1).kl_divergence(_stacy(d, t2, a2, b2)),
        tuple(POS[:6]), 1e-4),
    "stacy_wilson_prior": (lambda d, eps, sig, x: d.Stacy.wilson_prior(
        CENTRIC, eps, sig).log_prob(x), (POS[0], POS[1], X), 1e-5),
    "stacy_from_half_normal": (lambda d, s, x: d.Stacy.from_half_normal(
        s).log_prob(x), (POS[0], X), 1e-5),
    "stacy_from_weibull": (lambda d, k, s, x: d.Stacy.from_weibull(
        k, s).log_prob(x), (POS[0], POS[1], X), 1e-5),
    "normal_variance": (lambda d, loc, s: d.Normal(loc, s).variance(),
                        (X, POS[0]), 1e-5),
    "normal_kl": (lambda d, l1, s1, l2, s2: d.Normal(l1, s1).kl_divergence(
        d.Normal(l2, s2)), (X, POS[0], POS[1], POS[2]), 1e-4),
    "half_normal_variance": (lambda d, s: d.HalfNormal(s).variance(),
                             (POS[0],), 1e-5),
    "folded_normal_prob": (lambda d, loc, s, x: d.FoldedNormal(
        loc, s).prob(x - 1.0), (X, POS[0], X), 1e-5),
}


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_closed_forms_and_gradients_match_jax(name):
    fn, arrays, rtol = CLOSED[name]
    w = np.random.default_rng(41).normal(size=N).astype(np.float32)
    argnums = tuple(range(len(arrays)))
    want = fn(jd, *arrays)
    want_g = jax.grad(lambda *a: jnp.sum(w * fn(jd, *a)),
                      argnums=argnums)(*map(jnp.asarray, arrays))
    ts = [_t(a).requires_grad_(True) for a in arrays]
    got = fn(td, *ts)
    got_g = torch.autograd.grad((got * _t(w)).sum(), ts, allow_unused=True)
    _close(got, want, rtol=rtol)
    for t, g, wg in zip(ts, got_g, want_g):
        _close(torch.zeros_like(t) if g is None else g, wg, rtol=rtol,
               atol=10 * rtol)


def test_wilson_as_stacy_matches_jax():
    eps = POS[0]
    for sigma in (1.0, POS[1]):
        j = JWilson(CENTRIC, eps, sigma).as_stacy()
        t = WilsonPrior(torch.tensor(CENTRIC), _t(eps),
                        sigma if np.isscalar(sigma) else _t(sigma)).as_stacy()
        for a, b in zip(t, j):
            _close(a, b)
        _close(t.log_prob(_t(X)), j.log_prob(X))
        _close(t.mean(), j.mean())


# ------------------------------------------------------ draws at JAX noise
LOC = RNG.uniform(0.05, 3.0, N).astype(np.float32)
SCALE = RNG.uniform(0.05, 1.5, N).astype(np.float32)


@pytest.mark.parametrize("kind", ["folded_normal", "rice", "rice_woolfson"])
def test_draws_at_jax_normals_equal_jax_samples(kind):
    """JAX's sample(key, (2,)) against the port's draw from the normals
    that key gives: FoldedNormal's from normal(key), Rice's from
    normal(k1) and normal(k2) with (k1, k2) = split(key), RiceWoolfson's
    centric entries from the first and acentric ones from the other two;
    values and their gradients in loc and scale."""
    key = jax.random.PRNGKey(9)
    shape = (2, N)
    n0 = np.asarray(jax.random.normal(key, shape))
    k1, k2 = jax.random.split(key)
    n1, n2 = (np.asarray(jax.random.normal(k, shape)) for k in (k1, k2))
    w = np.random.default_rng(42).normal(size=shape).astype(np.float32)

    def jax_dist(loc, scale):
        return {"folded_normal": lambda: jd.FoldedNormal(loc, scale),
                "rice": lambda: jd.Rice(loc, scale),
                "rice_woolfson": lambda: jd.RiceWoolfson(loc, scale,
                                                         CENTRIC)}[kind]()

    def jax_obj(loc, scale):
        z = jax_dist(loc, scale).sample(key, (2,))
        return jnp.sum(w * z), z

    (_, z_j), g_j = jax.value_and_grad(jax_obj, argnums=(0, 1),
                                       has_aux=True)(LOC, SCALE)
    loc, scale = (_t(a).requires_grad_(True) for a in (LOC, SCALE))
    if kind == "folded_normal":
        z = td.FoldedNormal(loc, scale).sample_from_normal(_t(n0))
    elif kind == "rice":
        z = td.Rice(loc, scale).sample_from_normals(_t(n1), _t(n2))
    else:
        q = td.RiceWoolfson(loc, scale, torch.tensor(CENTRIC))
        noise = _t(np.stack([n0, n1, n2]))
        assert noise.shape == q.noise_shape(shape)
        z = q.sample_from_noise(noise)
    g = torch.autograd.grad((z * _t(w)).sum(), (loc, scale))
    _close(z, z_j, rtol=2e-6, atol=0)
    for a, b in zip(g, g_j):
        _close(a, b, rtol=1e-4, atol=1e-6)


def _moments(name):
    f = torch.tensor
    return {
        "normal": td.Normal(f([1.0, -2.0]), f([0.5, 2.0])),
        "laplace": td.Laplace(f([0.5]), f([1.5])),
        "studentt": td.StudentT(8.0, f([1.0]), f([0.7])),
        "half_normal": td.HalfNormal(f([0.3, 2.0])),
        "weibull": td.Weibull(f([2.0, 0.8]), f([1.0, 3.0])),
        "gamma": td.Gamma(f([0.4, 3.0]), f([2.0, 0.5])),
        "exponential": td.Exponential(f([0.5, 4.0])),
        "truncated_normal": td.TruncatedNormal(f([0.5, 2.0]), f([1.0, 0.3])),
        "folded_normal": td.FoldedNormal(f([0.2, 2.0]), f([1.0, 0.5])),
        "rice": td.Rice(f([0.3, 3.0]), f([1.0, 0.5])),
        "amoroso": td.Amoroso(f([-1.0, 0.5]), f([2.0, 0.5]), f([1.5, 3.0]),
                              f([2.0, 0.7])),
        "stacy": td.Stacy(f([1.0, 2.0]), f([0.5, 1.0]), f([2.0, 1.5])),
        "rice_woolfson": td.RiceWoolfson(f([0.5, 0.5]), f([1.0, 1.0]),
                                         f([True, False])),
        "wilson": WilsonPrior(f([True, False]), f([1.0, 2.0]), 1.5),
    }[name]


@pytest.mark.parametrize("name", ["normal", "laplace", "studentt",
                                  "half_normal", "weibull", "gamma",
                                  "exponential", "truncated_normal",
                                  "folded_normal", "rice", "amoroso",
                                  "stacy", "rice_woolfson", "wilson"])
def test_draws_have_the_closed_form_moments(name):
    d = _moments(name)
    n = 200_000
    z = d.sample(seeded_generator(5, "cpu"), (n,)).double()
    if name in ("gamma", "exponential"):   # the JAX classes have no moments
        rate = d.rate.double()
        conc = d.concentration.double() if name == "gamma" else 1.0
        mean, var = conc / rate, conc / rate ** 2
    else:
        mean = d.mean().double().expand(z.shape[1:])
    if name == "studentt":     # df / (df - 2) scale^2
        var = torch.full_like(mean, 8.0 / 6.0 * 0.49)
    elif name in ("laplace", "wilson"):
        var = d.stddev().double() ** 2
    elif name not in ("gamma", "exponential"):
        var = d.variance().double().expand(z.shape[1:])
    got_mean, got_var = z.mean(0), z.var(0)
    assert (torch.abs(got_mean - mean) < 5 * torch.sqrt(var / n)).all(), \
        (got_mean, mean)
    assert (torch.abs(got_var / var - 1) < 0.03).all(), (got_var, var)


def test_gamma_draws_carry_the_implicit_gradient():
    """d E[Gamma(c) / r] / dc = 1 / r, through torch._standard_gamma's
    implicit gradient, as jax.random.gamma's."""
    conc = torch.tensor([0.7, 3.0], requires_grad=True)
    z = td.Gamma(conc, torch.tensor([2.0, 0.5])).sample(
        seeded_generator(6, "cpu"), (200_000,))
    (g,) = torch.autograd.grad(z.mean(0).sum(), conc)
    _close(g, [0.5, 2.0], rtol=0.02)


# ---------------------------------------------------------- reference prior
KINDS = ["normal", "laplace", "studentt", "ricewoolfson"]


def _reference_inputs(kind, garbage):
    """tests/models/test_priors_likelihoods.py's inputs (its rng fixture's
    seed); with garbage, the unobserved entries' loc and scale cycle
    through nan, inf, 0 and -1, which the JAX docstring allows."""
    rng = np.random.default_rng(1234)
    n = 50
    observed = rng.random(n) < 0.6
    loc = np.abs(rng.normal(2, 0.5, n)).astype(np.float32)
    scale = (0.1 + rng.random(n)).astype(np.float32)
    centric = rng.random(n) < 0.3 if kind == "ricewoolfson" else None
    x = np.abs(rng.normal(2, 0.5, n)).astype(np.float32) + 0.1
    if garbage:
        idx = np.flatnonzero(~observed)
        loc[idx] = np.resize(np.float32([np.nan, np.inf, 0.0, -1.0]),
                             len(idx))
        scale[idx] = np.resize(np.float32([0.0, np.nan, np.inf, -1.0]),
                               len(idx))
    return observed, loc, scale, centric, x


@pytest.mark.parametrize("garbage", [False, True], ids=["clean", "garbage"])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_prior_matches_jax(kind, garbage):
    """log_prob (0 where unobserved), mean (1 there) and the gradient of
    sum(log_prob(|z| + 0.1)) in z, against JAX's, NaN for NaN: with
    garbage in unobserved entries both packages' selects pass the
    unselected branch's NaN derivative on to z."""
    observed, loc, scale, centric, x = _reference_inputs(kind, garbage)
    dof = 4.0 if kind == "studentt" else None
    j = JRef(observed, loc, scale, kind=kind, dof=dof, centric=centric)
    t = ReferencePrior(torch.tensor(observed), _t(loc), _t(scale), kind=kind,
                       dof=dof, centric=None if centric is None
                       else torch.tensor(centric))
    lp = t.log_prob(_t(x))
    _close(lp, j.log_prob(x))
    assert (lp[~torch.tensor(observed)] == 0).all()
    _close(t.mean(), j.mean())

    g_j = np.asarray(jax.grad(lambda z: jnp.sum(j.log_prob(
        jnp.abs(z) + 0.1)))(jnp.asarray(x)))
    z = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(t.log_prob(torch.abs(z) + 0.1).sum(), z)
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(g_j))
    _close(g, g_j)
    assert np.isnan(g_j).any() == garbage


# ------------------------------------------------------- neural likelihood
def _inputs_pair(n=400, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, 50, n), rng.integers(0, 5, n), np.zeros(n),
              rng.normal(size=(n, 3)).astype(np.float32),
              rng.gamma(2.0, 1.0, n).astype(np.float32),
              rng.uniform(0.1, 0.5, n).astype(np.float32))
    return JInputs.from_arrays(*arrays), Inputs.from_arrays(*arrays,
                                                            device="cpu")


@pytest.mark.parametrize("init", ["identity", "random"])
def test_neural_normal_likelihood_matches_jax(init):
    """log_prob and every weight's gradient, at JAX's identity init (whose
    zero pre-activations take the slope-1 side of the leaky ReLU, as
    jax.nn.leaky_relu does) and at random weights with nonzero biases,
    carried across by params_from_jax."""
    inputs_j, inputs = _inputs_pair()
    cfg_j, cfg = jmono.NeuralNormalLikelihood(3, 6), \
        mono.NeuralNormalLikelihood(3, 6)
    if init == "identity":
        jparams = cfg_j.init()
        for a, b in zip(jax.tree.leaves(params_to_numpy(cfg.init("cpu"))),
                        jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))
    else:
        rng = np.random.default_rng(3)
        jparams = jax.tree.map(
            lambda a: np.asarray(a) + 0.1 * rng.normal(
                size=np.shape(a)).astype(np.float32),
            cfg_j.init(jax.random.PRNGKey(1)))
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    ipred = np.random.default_rng(4).gamma(2.0, 1.0, inputs.n_obs).astype(
        np.float32)

    def jax_ll(p):
        return jnp.sum(cfg_j.build(p, inputs_j).log_prob(ipred))

    want, want_g = jax.value_and_grad(jax_ll)(
        jax.tree.map(jnp.asarray, jparams))
    p = params_from_jax(jparams, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    dist = cfg.build(p, inputs)
    _close(dist.stddev(), cfg_j.build(jparams, inputs_j).stddev())
    got = dist.log_prob(_t(ipred)).sum()
    _close(got, want)
    grads = torch.autograd.grad(got, leaves)
    want_g = jax.tree.leaves(want_g)
    assert len(grads) == len(want_g) == 2 * 3 + 2
    for g, w in zip(grads, want_g):   # sums over 400 rows in two orders
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_neural_normal_init_from_a_generator():
    cfg = mono.NeuralNormalLikelihood(2, 64)
    a = cfg.init("cpu", seeded_generator(0, "cpu"))
    b = cfg.init("cpu", seeded_generator(0, "cpu"))
    assert [k for k, _ in flatten_params(a)] == [
        "layers/0/b", "layers/0/w", "layers/1/b", "layers/1/w", "out/b",
        "out/w"]
    for (_, x), (_, y) in zip(flatten_params(a), flatten_params(b)):
        assert torch.equal(x, y)
    w = a["layers"][1]["w"]
    assert w.shape == (64, 64) and abs(float(w.std()) - 1 / 8) < 0.01
    assert torch.equal(a["out"]["w"], torch.eye(64, 1))


# ------------------------------------------------------ the parts together
N_OBS, N_REFL, N_IMG, D, LAYERS = 2000, 150, 12, 5, 3


def _together(seed=0):
    """The problem, both packages' parts (RiceWoolfsonPosterior, a normal
    ReferencePrior on ~60 % of the reflections, NeuralNormalLikelihood(3,
    6), the hybrid scaler) and JAX-layout starting parameters moved off
    their inits."""
    arrays, centric, f_true = _problem(N_OBS, N_REFL, N_IMG, D, seed=seed)
    rng = np.random.default_rng(seed + 10)
    observed = rng.random(N_REFL) < 0.6
    f_ref = np.abs(f_true * (1 + 0.1 * rng.normal(size=N_REFL))
                   ).astype(np.float32)
    s_ref = np.full(N_REFL, 0.1, np.float32)
    f_ref[~observed], s_ref[~observed] = 1.0, 1.0
    wilson = JWilson(centric, np.ones(N_REFL, np.float32))
    jparts = dict(
        posterior=JRWPost(centric=centric),
        prior=JRef(observed, f_ref, s_ref),
        likelihood=jmono.NeuralNormalLikelihood(3, 6),
        scaler=JHybrid(JMLP(LAYERS, D, scale_bijector="exp"),
                       JImage(N_IMG)))
    tparts = dict(
        posterior=RiceWoolfsonPosterior(centric=torch.tensor(centric)),
        prior=ReferencePrior(torch.tensor(observed), _t(f_ref), _t(s_ref)),
        likelihood=mono.NeuralNormalLikelihood(3, 6),
        scaler=HybridImageScaler(MLPScaler(LAYERS, D, scale_bijector="exp"),
                                 ImageScaler(N_IMG)))
    params = {"posterior": jparts["posterior"].init(
                  np.asarray(wilson.mean()), np.asarray(wilson.stddev())),
              "scaler": jparts["scaler"].init(jax.random.PRNGKey(0), D),
              "likelihood": jparts["likelihood"].init(
                  jax.random.PRNGKey(1))}
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    return arrays, jparts, tparts, params, f_true


def _jax_loss_fn(jparts, inputs_j, key_f, eps):
    def loss(params):
        q = jparts["posterior"].distribution(params["posterior"])
        z_f = q.sample(key_f)
        sd = jparts["scaler"].apply(params["scaler"], inputs_j)
        z_obs = jax_plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = jparts["likelihood"].build(params["likelihood"],
                                        inputs_j).log_prob(ipred).sum()
        kl = q.log_prob(z_f) - jparts["prior"].log_prob(z_f)
        return -ll + jnp.sum(kl)
    return loss


def _jax_noise(key_f, n_refl):
    """The (3, n_refl) normals behind JAX's RiceWoolfson.sample(key_f)."""
    k1, k2 = jax.random.split(key_f)
    return np.stack([np.asarray(jax.random.normal(k, (n_refl,)))
                     for k in (key_f, k1, k2)])


def _port_model(tparts):
    return VariationalMergingModel(**tparts, fused_kernel=True)


def test_library_elbo_matches_jax():
    """The three parts in one ELBO: the loss and every gradient against
    the JAX pieces' at JAX's noise (the normals of its key, the scale
    noise eps). fused_kernel=True takes the plain path, as in JAX: the
    likelihood has no fused kind."""
    arrays, jparts, tparts, params, _ = _together()
    inputs_j = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        N_REFL, N_IMG, mlp_width=D)
    key_f = jax.random.PRNGKey(5)
    eps = np.random.default_rng(1).standard_normal(N_OBS).astype(np.float32)
    loss_j, grads_j = jax.value_and_grad(_jax_loss_fn(
        jparts, inputs_j, key_f, eps))(jax.tree.map(jnp.asarray, params))

    model = _port_model(tparts)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(N_REFL, N_IMG)
    assert not model._fused_eligible(inputs)
    p = params_from_jax(params, "cpu")
    named = flatten_params(p)
    leaves = [t.requires_grad_(True) for _, t in named]
    loss, _ = model.elbo(p, inputs, u_f=_t(_jax_noise(key_f, N_REFL)),
                         eps=_t(eps))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(grads_j)
    assert len(want) == len(grads) == 2 + 2 * LAYERS + 2 + 1 + 2 * 3 + 2
    for (name, _), g, w in zip(named, grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_library_adam_steps_match_optax():
    """Three steps as the Trainer takes them (its gradients, transform and
    Adam) and as the JAX Trainer's optax chain takes them, each step at
    its own JAX noise: the parameters after each step."""
    arrays, jparts, tparts, params, _ = _together(seed=1)
    inputs_j = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        N_REFL, N_IMG, mlp_width=D)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(N_REFL, N_IMG)
    trainer = Trainer(_port_model(tparts))
    p = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    frozen = [False] * len(leaves)
    opt = trainer.optimizer(leaves)
    jopt = JTrainer(None).optimizer()
    pj = jax.tree.map(jnp.asarray, params)
    state = jopt.init(pj)
    rng = np.random.default_rng(2)
    for step in range(3):
        key_f = jax.random.PRNGKey(20 + step)
        eps = rng.standard_normal(N_OBS).astype(np.float32)
        g = jax.grad(_jax_loss_fn(jparts, inputs_j, key_f, eps))(pj)
        updates, state = jopt.update(g, state, pj)
        pj = optax.apply_updates(pj, updates)

        loss, _ = trainer.model.elbo(p, inputs,
                                     u_f=_t(_jax_noise(key_f, N_REFL)),
                                     eps=_t(eps))
        grads, _ = trainer.transform_grads(
            trainer.gradients(loss, leaves, frozen), frozen)
        for leaf, gl in zip(leaves, grads):
            leaf.grad = gl
        opt.step()
        for a, b in zip(jax.tree.leaves(params_to_numpy(p)),
                        jax.tree.leaves(pj)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_library_model_trains_and_resumes_bit_for_bit(tmp_path):
    """Trainer.train with the three parts draws RiceWoolfson's normals from
    its generator: 300 steps lower the loss and bring the posterior mean
    towards the true F (CC measured 0.41 from about 0; the bar is 0.3); a
    run resumed from its own checkpoint (the likelihood's layers among
    the parameters and Adam moments) repeats the uninterrupted run bit for
    bit."""
    arrays, _, tparts, params, f_true = _together(seed=2)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(N_REFL, N_IMG)
    trainer = Trainer(_port_model(tparts))
    start = params_from_jax(params, "cpu")
    trained, history = trainer.train(start, seeded_generator(0, "cpu"),
                                     inputs, 300, chunk_size=100,
                                     device="cpu")
    loss = np.asarray(history["loss"])
    assert np.isfinite(loss).all() and loss[-10:].mean() < loss[:10].mean()
    mean = trainer.model.posterior.distribution(
        trained["posterior"]).mean().numpy()
    assert np.corrcoef(mean, f_true)[0, 1] > 0.3

    ckpt = str(tmp_path / "ckpt")
    runs = {}
    for name, steps, resume in (("A", 8, None), ("B", 5, None),
                                ("C", 8, ckpt)):
        runs[name] = trainer.train(
            start, seeded_generator(0 if name != "C" else 99, "cpu"),
            inputs, steps, chunk_size=5, device="cpu",
            checkpoint_path=ckpt if name == "B" else None,
            checkpoint_frequency=5, resume_from=resume)
    (pa, ha), (pc, hc) = runs["A"], runs["C"]
    assert any(k.startswith("likelihood/layers/") for k, _ in
               flatten_params(pa))
    for (ka, a), (kc, c) in zip(flatten_params(pa), flatten_params(pc)):
        assert ka == kc and torch.equal(a, c), ka
    assert ha == hc


def test_truncated_normal_draw_is_the_generators_uniforms():
    """The truncated normal's draw through its draw_noise is the one the
    Trainer made before the surrogate owned its draw: (S, n_refl) uniforms
    of torch.rand from the same generator, in the same order, so every
    seeded run, checkpoint and crossvalidation keeps its numbers."""
    post = TruncatedNormalPosterior(low=torch.zeros(40))
    params = post.init(np.full(40, 1.5), np.full(40, 0.4), "cpu")
    q = post.distribution(params)
    for S in (1, 2):
        a, b = seeded_generator(7, "cpu"), seeded_generator(7, "cpu")
        noise = post.family.draw_noise(a, (S, 40), "cpu")
        u = torch.rand((S, 40), generator=b, device="cpu",
                       dtype=torch.float32)
        assert torch.equal(noise, u)
        assert torch.equal(q.sample_from_noise(noise),
                           q.sample_from_uniform(u))
        assert torch.equal(a.get_state(), b.get_state())
