"""The priors of --analytic-kl and --double-wilson-parents against
careless_tpu, on the CPU.

Same f32 inputs on both sides. The distributions (TruncatedNormal's
moment_2, the Wilson prior's expected_log_prob, FoldedNormal, Rice below
and past its normal crossover at nu / sigma = 40 and at small x, and
RiceWoolfson): log_prob, mean and variance and their gradients at rtol
1e-5. DoubleWilsonPrior.from_asu_collection's parent table and roots bit
for bit on two ASUs, with and without a reindexing op and with parents
missing. The ELBO of the models build_model gives (--analytic-kl over the
Wilson prior; the double-Wilson prior with and without
--optimize-double-wilson-r, and with --analytic-kl, which it ignores) at
rtol 1e-5 from the same parameters, uniforms and noise, with the
gradients of the prior's r and of the posterior's terms that no
observation reaches at rtol 1e-5 and the rest within 1e-4 of each
tensor's largest entry (test_torch_elbo.py's bar: the JAX package's
segment sum differences a flat f32 cumsum). A 3-step two-file
`--double-wilson-parents` CLI run of each package: the same files,
columns and rows, and the history's rDW_0 and rDW_1. The JAX package's
own cases (tests/models/test_analytic_kl.py, test_double_wilson.py) are
mirrored on the port.
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io.asu import ReciprocalASU as JASU
from careless_tpu.io.asu import ReciprocalASUCollection as JRAC
from careless_tpu.io.manager import DataManager as JDataManager
from careless_tpu.main import main as jax_main
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.priors.double_wilson import \
    DoubleWilsonPrior as JDoubleWilson
from careless_tpu.models.priors.wilson import WilsonPrior as JWilson
from careless_tpu.ops import distributions as jd
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu_torch.io.asu import ReciprocalASU, ReciprocalASUCollection
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.models.priors.double_wilson import (
    DoubleWilsonPrior, parse_parents)
from careless_tpu_torch.models.priors.wilson import WilsonPrior
from careless_tpu_torch.ops import distributions as td
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy
from careless_tpu_torch.xtal import SpaceGroup, UnitCell, read_mtz

torch.set_num_threads(2)

CELL = (30.0, 30.0, 40.0, 90.0, 90.0, 90.0)
SG = "P 21 21 21"


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _value_and_grads(port_fn, jax_fn, args):
    """((port value, its gradients), (JAX value, its gradients)): the
    gradients of the sum against random weights in every argument."""
    w = np.random.default_rng(0).normal(
        size=np.shape(jax_fn(*args))).astype(np.float32)
    want, grads = jax.value_and_grad(
        lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(args))))(
        *args)
    ts = [_t(a).requires_grad_(True) for a in args]
    got = port_fn(*ts)
    g = torch.autograd.grad((got * _t(w)).sum(), ts)
    return ((got.detach().numpy(), [x.numpy() for x in g]),
            (np.asarray(jax_fn(*args)), [np.asarray(x) for x in grads]), w)


def _hold(port_fn, jax_fn, args, rtol=1e-5, atol=1e-6):
    """port_fn(*tensors) against jax_fn(*arrays): the value, and the
    gradient of its sum against random weights in every argument."""
    (got, g), (want, gw), _ = _value_and_grads(port_fn, jax_fn, args)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    for a, b in zip(g, gw):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _tn_args(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, n).astype(np.float32),
            rng.uniform(0.05, 1.0, n).astype(np.float32))


def test_truncated_normal_moment_2():
    low = np.where(np.arange(60) % 3 == 0, 0.0, 1e-32).astype(np.float32)
    _hold(lambda loc, s: td.TruncatedNormal(loc, s, _t(low)).moment_2(),
          lambda loc, s: jd.TruncatedNormal(loc, s, low).moment_2(),
          _tn_args())


@pytest.mark.parametrize("mc", [1, 3])
def test_wilson_expected_log_prob(mc):
    """Centric and acentric, per-reflection Sigma, a leading MC axis or
    none: the value and its gradients in q's loc and scale and in z."""
    rng = np.random.default_rng(2)
    loc, scale = _tn_args(seed=2)
    centric = rng.random(60) < 0.4
    eps = rng.choice([1.0, 2.0, 3.0], 60).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, 60).astype(np.float32)
    low = (1e-32 * ~centric).astype(np.float32)
    z = rng.uniform(0.1, 3.0, (mc, 60) if mc > 1 else 60).astype(np.float32)

    def port(loc, s, z):
        return WilsonPrior(torch.tensor(centric), _t(eps), _t(sigma)
                           ).expected_log_prob(
            td.TruncatedNormal(loc, s, _t(low)), z)

    def jax_fn(loc, s, z):
        return JWilson(centric, eps, sigma).expected_log_prob(
            jd.TruncatedNormal(loc, s, low), z)
    _hold(port, jax_fn, (loc, scale, z))


def test_folded_normal():
    rng = np.random.default_rng(3)
    loc = rng.normal(0.0, 2.0, 50).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, 50).astype(np.float32)
    x = rng.uniform(0.01, 5.0, 50).astype(np.float32)
    _hold(lambda u, s, x: td.FoldedNormal(u, s).log_prob(x),
          lambda u, s, x: jd.FoldedNormal(u, s).log_prob(x), (loc, scale, x))
    for name in ("mean", "variance"):
        _hold(lambda u, s: getattr(td.FoldedNormal(u, s), name)(),
              lambda u, s: getattr(jd.FoldedNormal(u, s), name)(),
              (loc, scale), atol=1e-5)
    assert torch.isnan(td.FoldedNormal(_t([1.0]), _t([1.0])).log_prob(
        _t([-0.5]))).all()


# nu / sigma below the crossover, past it (the normal branch), and x near 0
RICE_CASES = {"below": (0.0, 20.0, 0.2), "past": (45.0, 80.0, 0.5),
              "small_x": (0.0, 3.0, 1e-3)}


def _rice_moments_f64(nu, sigma):
    """Rice's mean and variance by distributions.py's formulas in f64."""
    snr = nu / sigma
    x = -0.5 * snr * snr
    ax = torch.abs(0.5 * x)
    lag = ((1.0 - x) * torch.exp(x / 2.0 + torch.log(
        torch.special.i0e(-0.5 * x)) + ax)
        - x * torch.exp(x / 2.0 + torch.log(torch.special.i1e(-0.5 * x))
                        + ax))
    mean = sigma * np.sqrt(np.pi / 2.0) * lag
    var = 2.0 * sigma * sigma + nu * nu - 0.5 * np.pi * sigma * sigma * lag ** 2
    past = snr > 40.0
    return (torch.where(past, nu, mean), torch.where(past, sigma * sigma, var))


def _hold_moments_to_f64(port_cls, jax_cls, nu, sigma, *extra):
    """mean and variance, and their gradients, no farther from the f64
    formulas than 3x the JAX package's distance (plus 1e-6 of the largest
    entry): the Laguerre form subtracts nearly equal terms, so the two f32
    libraries' gradients lie up to ~1e-2 of the largest entry from the f64
    ones (measured: the port 2.6x JAX's at most, 1.1-1.2x for the
    variance) and agree with each other no better. The ELBO never takes
    these gradients: the prior's log_prob is all it differentiates."""
    for i, name in enumerate(("mean", "variance")):
        (got, g), (want, gw), w = _value_and_grads(
            lambda n, s: getattr(port_cls(n, s, *extra), name)(),
            lambda n, s: getattr(jax_cls(n, s, *extra), name)(),
            (nu, sigma))
        ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (nu, sigma)]
        ref = _rice_moments_f64(*ts)[i]
        if extra:   # RiceWoolfson: the folded normal's centric moments
            c = torch.as_tensor(np.asarray(extra[0]))
            fold = jd.FoldedNormal(nu, sigma)
            ref = torch.where(c, torch.tensor(np.asarray(
                getattr(fold, name)()), dtype=torch.float64), ref)
        g64 = torch.autograd.grad((ref * torch.tensor(w, dtype=torch.float64)
                                   ).sum(), ts, allow_unused=True)
        for a, b, c in [(got, want, ref.detach().numpy())] + [
                (x, y, z.numpy()) for x, y, z in zip(g, gw, g64)]:
            scale = np.abs(c).max()
            mine, theirs = np.abs(a - c).max(), np.abs(b - c).max()
            assert mine <= 3 * theirs + 1e-6 * scale + 1e-12, (
                name, mine, theirs)


@pytest.mark.parametrize("case", sorted(RICE_CASES))
def test_rice(case):
    lo, hi, x_scale = RICE_CASES[case]
    rng = np.random.default_rng(4)
    sigma = rng.uniform(0.2, 1.5, 40).astype(np.float32)
    nu = (sigma * rng.uniform(lo, hi, 40)).astype(np.float32)
    x = (x_scale * (nu + sigma) * rng.uniform(0.5, 1.5, 40)).astype(
        np.float32)
    _hold(lambda n, s, x: td.Rice(n, s).log_prob(x),
          lambda n, s, x: jd.Rice(n, s).log_prob(x), (nu, sigma, x),
          atol=1e-5)
    _hold_moments_to_f64(td.Rice, jd.Rice, nu, sigma)


def test_rice_woolfson():
    rng = np.random.default_rng(5)
    centric = rng.random(50) < 0.5
    loc = rng.uniform(0.0, 3.0, 50).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, 50).astype(np.float32)
    x = rng.uniform(0.05, 4.0, 50).astype(np.float32)
    c = torch.tensor(centric)
    # atol: 1e-6 of the largest gradient entry (~80), where Rice's
    # d log I0 = i1e / i0e - sign cancels in both packages
    _hold(lambda u, s, x: td.RiceWoolfson(u, s, c).log_prob(x),
          lambda u, s, x: jd.RiceWoolfson(u, s, centric).log_prob(x),
          (loc, scale, x), atol=1e-4)
    _hold_moments_to_f64(
        lambda u, s, _: td.RiceWoolfson(u, s, c),
        lambda u, s, _: jd.RiceWoolfson(u, s, centric), loc, scale, centric)


def _racs(dmins=(5.0, 5.0), anomalous=(False, False)):
    """The same ASU collection in both packages."""
    def make(asu_cls, rac_cls, uc, sg):
        return rac_cls([asu_cls(uc, sg, d, a)
                        for d, a in zip(dmins, anomalous)])
    return (make(ReciprocalASU, ReciprocalASUCollection, UnitCell(*CELL),
                 SpaceGroup.from_name(SG)),
            make(JASU, JRAC, jx.UnitCell(*CELL), jx.SpaceGroup.from_name(SG)))


# (parents, reindexing ops, dmins, anomalous)
TABLES = {
    "parent": ([None, 0], None, (5.0, 5.0), (False, False)),
    "identity_op": ([None, 0], ["x,y,z", "x,y,z"], (5.0, 5.0),
                    (False, False)),
    "swap_op": ([None, 0], ["x,y,z", "y,x,-z"], (5.0, 5.0), (False, False)),
    "missing": ([None, 0], None, (6.0, 5.0), (False, False)),
    "chain": ([None, 0, 1], None, (5.0, 5.0, 5.0), (False, True, False)),
}


@pytest.mark.parametrize("case", sorted(TABLES))
def test_parent_table_is_the_jax_one(case):
    parents, ops, dmins, anomalous = TABLES[case]
    port, jrac = _racs(dmins, anomalous)
    r = [0.0] + [0.9] * (len(parents) - 1)
    got = DoubleWilsonPrior.from_asu_collection(port, parents, r, ops)
    want = JDoubleWilson.from_asu_collection(jrac, parents, r, ops)
    for name in ("reflids", "root", "asu_ids", "centric", "multiplicity"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert bool(got.absent.any()) == (case == "missing")
    z = np.abs(np.random.default_rng(3).normal(1, 0.3, port.n_refl)
               ).astype(np.float32)
    np.testing.assert_allclose(got.log_prob(_t(z)).numpy(),
                               np.asarray(want.log_prob(z)), rtol=1e-5,
                               atol=1e-5)


def test_root_is_wilson_and_a_child_at_r_0_ignores_its_parent():
    port, _ = _racs()
    n0 = len(port.reciprocal_asus[0])
    dw = DoubleWilsonPrior.from_asu_collection(port, [None, 0], [0.0, 0.0])
    wilson = WilsonPrior(torch.tensor(port.centric),
                         _t(port.multiplicity), 1.0)
    rng = np.random.default_rng(1)
    z1 = _t(np.abs(rng.normal(1, 0.3, port.n_refl)))
    z2 = z1.clone()
    z2[:n0] = _t(np.abs(rng.normal(1, 0.3, n0)))
    torch.testing.assert_close(dw.log_prob(z1)[:n0], wilson.log_prob(z1)[:n0])
    torch.testing.assert_close(dw.log_prob(z1)[n0:], dw.log_prob(z2)[n0:])


def test_trainable_r_couples_the_parent():
    """optimize_r: r_raw = logit(r), the rDW metrics, a gradient in r and
    in the parent block through the child's term."""
    port, _ = _racs()
    n0 = len(port.reciprocal_asus[0])
    dw = DoubleWilsonPrior.from_asu_collection(port, [None, 0], [0.5, 0.5],
                                               optimize_r=True)
    params = {k: v.requires_grad_(True) for k, v in dw.init().items()}
    dist = dw.build(params)
    torch.testing.assert_close(dist.r, _t([0.5, 0.5]))
    assert set(dist.metrics()) == {"rDW_0", "rDW_1"}
    z = (torch.abs(torch.randn(port.n_refl, generator=torch.Generator()
                               .manual_seed(0))) + 0.5).requires_grad_(True)
    g_r, g_z = torch.autograd.grad(dist.log_prob(z)[n0:].sum(),
                                   (params["r_raw"], z))
    assert torch.isfinite(g_r).all() and g_r[1] != 0 and g_r[0] == 0
    assert g_z[:n0].abs().sum() > 0
    assert DoubleWilsonPrior.from_asu_collection(
        port, [None, 0], [0.5, 0.5]).init() == {}


def test_parse_parents():
    assert parse_parents("None,0") == [None, 0]
    assert parse_parents("None, None,1") == [None, None, 1]


def _two_file_managers(flags, seed=5, n=3000, n_images=12, d=4):
    """Both packages' managers of chip_smoke.two_file_problem's data at
    P 21 21 21 to 5 A, with `flags` over the CLI defaults."""
    arrays, port_rac, _ = chip_smoke.two_file_problem(
        seed, n, n_images, d, cell=CELL, spacegroup=SG, dmin=5.0)
    _, jrac = _racs()
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed,
                                      **flags})
    return (DataManager(Inputs.from_arrays(*arrays, device="cpu"), port_rac,
                        parser, device="cpu"),
            JDataManager(JInputs.from_arrays(*arrays), jrac, parser))


def _one_file_managers(flags, seed=6):
    arrays, asu, _ = chip_smoke.build_problem(seed, 2500, 200, 12, 4)
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed,
                                      **flags})
    return (DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                        parser, device="cpu"),
            JDataManager(JInputs.from_arrays(*arrays), asu, parser))


DW = dict(parents="None,0", dwr="0.,0.9")
MODELS = {
    "analytic_kl": (False, dict(analytic_kl=True)),
    "double_wilson": (True, DW),
    "double_wilson_optimize_r": (True, dict(DW,
                                            optimize_double_wilson_r=True)),
    "double_wilson_analytic_kl": (True, dict(DW, analytic_kl=True,
                                             optimize_double_wilson_r=True)),
}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_elbo_and_gradients_match_jax(case):
    """build_model's parameters equal the JAX package's (params["prior"]
    too); from them moved off the prior, the same uniforms and noise, the
    loss, NLL, KL and every gradient against the JAX model's ELBO."""
    two, flags = MODELS[case]
    port, jdm = (_two_file_managers if two else _one_file_managers)(flags)
    model, params, _ = port.build_model()
    jmodel, jparams, _ = jdm.build_model()
    assert model.analytic_kl == jmodel.analytic_kl
    assert model.metric_names == jmodel.metric_names
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    want_start = dict(flatten_params(params_from_jax(jparams, "cpu")))
    for name, t in flatten_params(params):
        np.testing.assert_allclose(t.numpy(), want_start[name].numpy(),
                                   rtol=1e-5, err_msg=name)
    rng = np.random.default_rng(7)
    for k in ("loc_raw", "scale_raw"):
        jparams["posterior"][k] = jparams["posterior"][k] + 0.1 * \
            rng.normal(size=jparams["posterior"][k].shape).astype(np.float32)
    inputs_j = jdm.inputs.sorted_by_refl().with_plans(
        jdm.n_refl, jdm.n_images, mlp_width=jdm.mlp_width)
    key_f = jax.random.PRNGKey(3)
    u_f = np.asarray(jax.random.uniform(key_f, (jdm.n_refl,)))
    eps = rng.standard_normal(inputs_j.n_obs).astype(np.float32)

    def jax_loss(params):
        q = jmodel.posterior.distribution(params["posterior"])
        z_f = q.sample(key_f)
        sd = jmodel.scaler.apply(params["scaler"], inputs_j)
        z_obs = jax_plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = jmodel.likelihood.build({}, inputs_j).log_prob(ipred).sum()
        kl, _ = jmodel._kl_terms(q, jmodel._built_prior(params), z_f[None])
        return -ll + kl, (ll, kl)

    (loss_j, (ll_j, kl_j)), grads_j = jax.value_and_grad(
        jax_loss, has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    p = params_from_jax(jparams, "cpu")
    named = flatten_params(p)
    leaves = [t.requires_grad_(True) for _, t in named]
    loss, metrics = model.elbo(p, port.planned_inputs().inputs,
                               u_f=torch.tensor(u_f), eps=torch.tensor(eps))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(metrics["NLL"].item(), -float(ll_j),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["F KLDiv"].item(), float(kl_j),
                               rtol=1e-5)
    if two:
        assert set(metrics) >= {"rDW_0", "rDW_1"}
        np.testing.assert_allclose(metrics["rDW_1"].item(), 0.9, rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = dict(zip([n for n, _ in named], jax.tree.leaves(grads_j)))
    seen = np.bincount(port.inputs.refl_id.numpy(), minlength=port.n_refl)
    for (name, _), g in zip(named, grads):
        w = np.asarray(want[name])
        if name.startswith("prior"):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
            continue
        if name.startswith("posterior"):   # reflections no row reaches
            np.testing.assert_allclose(g.numpy()[seen == 0], w[seen == 0],
                                       rtol=1e-5, atol=1e-5)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_analytic_kl_has_the_mc_expectation_and_less_variance():
    """The JAX package's test_analytic_kl.py cases on the port's pieces
    (its _setup: a Wilson prior and a narrow truncated normal): over 64
    single-sample draws the Rao-Blackwellized KL's mean lies within 3
    standard errors (and 0.02) of the MC estimate over 50,000 samples on
    every reflection, its variance is under half the single-sample MC
    one's, and centric reflections, fully closed-form, take none."""
    rng = np.random.default_rng(0)
    n = 200
    centric = rng.random(n) < 0.4
    prior = WilsonPrior(torch.tensor(centric),
                        _t(rng.choice([1.0, 2.0, 3.0], n)), 1.0)
    q = td.TruncatedNormal(_t(np.abs(rng.normal(1.2, 0.4, n))),
                           _t(0.05 + 0.2 * rng.random(n)),
                           _t(1e-32 * ~centric), 1e10)
    gen = torch.Generator().manual_seed(0)
    z_big = q.sample(gen, (50_000,))
    mc = (q.log_prob(z_big) - prior.log_prob(z_big)).mean(0)
    rb = torch.stack([-q.entropy() - prior.expected_log_prob(
        q, q.sample(gen, (1,))) for _ in range(64)])
    z = q.sample(gen, (64,))
    single = q.log_prob(z) - prior.log_prob(z)
    se = rb.std(0) / 8.0
    assert ((rb.mean(0) - mc).abs() <= 3 * se + 0.02).all()
    assert rb.var(0).mean() < 0.5 * single.var(0).mean()
    assert rb.var(0)[torch.tensor(centric)].max() < 1e-10


@pytest.fixture(scope="module")
def dw_cli(tmp_path_factory):
    """Each CLI's 3-step two-file double-Wilson run."""
    d = tmp_path_factory.mktemp("dw")
    files = []
    for seed in (1, 2):
        (cols, types_), _, _ = chip_smoke.synthetic_mtz(
            seed, 3000, 20, CELL, SG, 4.0)
        files.append(str(d / f"{seed}.mtz"))
        jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                                spacegroup=jx.SpaceGroup.from_name(SG),
                                mtz_dtypes=types_), files[-1])
    argv = ["mono", "dHKL,image_id,XDET", *files, None, "--iterations=3",
            "--mlp-layers=2", "--disable-progress-bar", "--separate-files",
            "--double-wilson-parents=None,0", "--double-wilson-r=0.,0.9",
            "--optimize-double-wilson-r"]
    out = {}
    for pkg, run, extra in (("jax", jax_main, []),
                            ("port", port_main, ["--disable-gpu"])):
        argv[4] = out[pkg] = str(d / pkg)
        run(argv + extra)
    return files, out


def test_cli_double_wilson_writes_the_jax_files(dw_cli):
    _, out = dw_cli
    for suffix in ("_0.mtz", "_1.mtz", "_predictions_0.mtz",
                   "_predictions_1.mtz"):
        t, j = (read_mtz(out[p] + suffix) for p in ("port", "jax"))
        assert t.columns == j.columns and t.mtz_dtypes == j.mtz_dtypes
        assert len(t) == len(j) > 50, suffix
        np.testing.assert_array_equal(t.get_hkls(), j.get_hkls())
    t, j = (pd.read_csv(out[p] + "_history.csv") for p in ("port", "jax"))
    assert list(t.columns) == list(j.columns) == [
        "step", "loss", "NLL", "F KLDiv", "rDW_0", "rDW_1", "Grad Norm"]
    assert len(t) == 3 and np.isfinite(t.to_numpy()).all()
    assert ((t["rDW_1"] > 0.85) & (t["rDW_1"] < 0.95)).all()
    for suffix in ("_scale.npz", "_structure_factor.npz"):
        assert sorted(np.load(out["port"] + suffix).files) == sorted(
            np.load(out["jax"] + suffix).files)


@pytest.mark.parametrize("r,match", [("0.,1.5", "allowed range"),
                                     ("-1.,0.5", "allowed range")])
def test_r_outside_the_range_raises_as_jax(dw_cli, tmp_path, r, match):
    files, _ = dw_cli
    argv = ["mono", "dHKL,image_id,XDET", *files, str(tmp_path / "x"),
            "--iterations=1", "--separate-files",
            "--double-wilson-parents=None,0", f"--double-wilson-r={r}"]
    with pytest.raises(ValueError, match=match) as got:
        port_main(argv + ["--disable-gpu"])
    with pytest.raises(ValueError) as want:
        jax_main(argv)
    assert str(got.value) == str(want.value)


def test_negative_r_warns_as_jax():
    port, jdm = _two_file_managers(dict(parents="None,0", dwr="0.,-0.5"))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        port.build_model()
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jdm.build_model()
    messages = [str(w.message) for w in got if "negative" in str(w.message)]
    assert messages == [str(w.message) for w in want
                        if "negative" in str(w.message)]
    assert messages == ["Supplied --double-wilson-r value -0.5 is negative"]


def test_prior_params_round_trip_through_params_from_jax():
    port, _ = _two_file_managers(dict(DW, optimize_double_wilson_r=True))
    _, params, _ = port.build_model()
    again = params_from_jax(params_to_numpy(params), "cpu")
    assert torch.equal(again["prior"]["r_raw"], params["prior"]["r_raw"])
    assert params["prior"]["r_raw"].shape == (2,)
