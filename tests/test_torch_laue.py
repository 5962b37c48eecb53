"""The port's Laue merge against careless_tpu: the chain layout, the sorted
inputs and their plans, the convolved likelihoods, the ELBO and a short
training run.

The data is chip_smoke.py's copy of bench.py's synthetic Laue problem at a
small size. Host-side plans and layouts are integer arrays and must be
equal. Tolerances: likelihood sums and the loss at rtol 1e-5 (f32 sums of
a few thousand terms in another order); gradients in the predictions at
rtol 1e-5 with atol 1e-5 of their largest entry; the Ev11 raw scalars'
gradients, sums over every row and the tail, at rtol 1e-4; each ELBO
gradient within 1e-4 of its tensor's largest entry, as in
tests/test_torch_elbo.py. The JAX package runs its Pallas kernels in
interpret mode, as its own tests do on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import careless_tpu.ops.plan_gather as jpg
import careless_tpu_torch.ops.plan_gather as tpg
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods import laue as jlaue
from careless_tpu.ops import chain_layout as jchain
from careless_tpu.ops.conv_runs import make_conv_run_plan as jax_run_plan
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import laue
from careless_tpu_torch.models.merging.variational import (flatten_params,
                                                           map_params)
from careless_tpu_torch.ops import chain_layout as tchain
from careless_tpu_torch.ops.conv_runs import make_conv_run_plan
from careless_tpu_torch.utils.params import params_from_jax
from chip_smoke import MONO_DEFAULTS, build_problem
from tests.test_torch_elbo import _jax_parts, _torch_model

torch.set_num_threads(2)

N, N_REFL, N_IMAGES, D = 3000, 400, 9, 4
FIELDS = ("refl_id", "image_id", "file_id", "metadata", "intensities",
          "uncertainties", "wavelength", "harmonic_id")


def _problem(seed=0, n=N, n_refl=N_REFL):
    arrays, asu, f_true = build_problem(seed, n, n_refl, N_IMAGES, D,
                                        laue=True)
    return arrays, asu, f_true


@pytest.fixture
def lowered_cap(monkeypatch):
    """The VMEM cap lowered in both packages, so that the observation axis
    (24 rows of 128 at N = 3000) is past it and the plans stream."""
    monkeypatch.setattr(jpg, "MAX_TABLE_ROWS", 8)
    monkeypatch.setattr(tpg, "MAX_TABLE_ROWS", 8)


def test_problem_is_bench_laue_problem():
    """chip_smoke.build_problem(laue=True) makes bench.py's data."""
    from bench import build_problem as bench_problem
    arrays, _, _ = _problem(seed=4, n=1500, n_refl=200)
    _, _, _, inputs_j = bench_problem(1500, 200, N_IMAGES, D, seed=4,
                                      laue=True, plans=False)
    for name, a in zip(FIELDS, arrays):
        np.testing.assert_array_equal(
            np.asarray(getattr(inputs_j, name)),
            np.asarray(a, np.asarray(getattr(inputs_j, name)).dtype),
            err_msg=name)


@pytest.mark.parametrize("seed,shuffle", [(0, False), (1, True)])
def test_chain_layout_matches_jax(seed, shuffle):
    arrays, _, _ = _problem(seed)
    rid, hid = arrays[0], arrays[7]
    if shuffle:   # the layout depends on the data, not the row order
        order = np.random.default_rng(seed).permutation(len(rid))
        rid, hid = rid[order], hid[order]
    np.testing.assert_array_equal(tchain.chain_labels(rid, hid, N_REFL),
                                  jchain.chain_labels(rid, hid, N_REFL))
    for a, b in zip(tchain.chain_permutation(rid, hid, N_REFL),
                    jchain.chain_permutation(rid, hid, N_REFL)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tchain.chain_row_order(rid, hid, N_REFL),
                                  jchain.chain_row_order(rid, hid, N_REFL))


@pytest.mark.parametrize("n_refl", [N_REFL, None])   # chain, legacy mode
def test_sorted_by_harmonic_matches_jax(n_refl):
    arrays, _, _ = _problem(2)
    got = Inputs.from_arrays(*arrays, device="cpu").sorted_by_harmonic(
        n_refl)
    want = JInputs.from_arrays(*arrays).sorted_by_harmonic(n_refl)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.plans is None


def test_conv_run_plan_matches_jax():
    arrays, _, _ = _problem(3)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_harmonic(
        N_REFL)
    got = make_conv_run_plan(inputs.harmonic_id, inputs.intensities,
                             inputs.uncertainties)
    want = jax_run_plan(inputs.harmonic_id.numpy(),
                        inputs.intensities.numpy(),
                        inputs.uncertainties.numpy())
    assert got.max_run == want.max_run
    for name in ("start_ll_mask", "run_len", "iobs_row", "sig_row",
                 "tail_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # unsorted group ids do not qualify
    assert make_conv_run_plan(np.array([1, 0, 0]), np.ones(3),
                              np.ones(3)) is None


def test_plans_travel_with_their_fields():
    """Replacing a field the plans are built from drops them, as
    careless_tpu's Inputs.replace does; other fields keep them."""
    arrays, _, _ = _problem(5)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_harmonic(
        N_REFL).with_plans(N_REFL, N_IMAGES)
    assert isinstance(inputs.plans.refl, tpg.ChainGatherPlan)
    assert inputs.plans.harmonic_run is not None
    for name in ("intensities", "uncertainties", "harmonic_id", "refl_id",
                 "image_id", "metadata"):
        assert inputs.replace(**{name: getattr(inputs, name)}).plans is None
    for name in ("file_id", "wavelength"):
        kept = inputs.replace(**{name: getattr(inputs, name)})
        assert kept.plans is inputs.plans
    with pytest.raises(ValueError, match="Laue"):
        inputs.sorted_by_refl()
    mono = Inputs.from_arrays(*arrays[:6], device="cpu")
    assert not mono.is_laue
    with pytest.raises(ValueError, match="Laue inputs only"):
        mono.sorted_by_harmonic()


def _jax_inputs(arrays):
    return JInputs.from_arrays(*arrays).sorted_by_harmonic(N_REFL).with_plans(
        N_REFL, N_IMAGES, mlp_width=D)


def _torch_inputs(arrays):
    return Inputs.from_arrays(*arrays, device="cpu").sorted_by_harmonic(
        N_REFL).with_plans(N_REFL, N_IMAGES)


LIKELIHOODS = {
    "normal": (jlaue.NormalLikelihood(), laue.NormalLikelihood()),
    "laplace": (jlaue.LaplaceLikelihood(), laue.LaplaceLikelihood()),
    "studentt": (jlaue.StudentTLikelihood(4.0), laue.StudentTLikelihood(4.0)),
    "normal_ev11": (jlaue.NormalEv11Likelihood(),
                    laue.NormalEv11Likelihood()),
    "studentt_ev11": (jlaue.StudentTEv11Likelihood(4.0),
                      laue.StudentTEv11Likelihood(4.0)),
}


def _drop_run(inputs):
    return dataclasses.replace(inputs, plans=dataclasses.replace(
        inputs.plans, harmonic_run=None))


@pytest.mark.parametrize("run", [True, False])
@pytest.mark.parametrize("lik", list(LIKELIHOODS))
def test_masked_ll_sum_matches_jax(lik, run):
    """The run-aligned form (run) and the planned convolution: the sum, its
    gradient in the predictions and, for Ev11, in the raw scalars, whose
    gradient also flows through the tail of never-hit group rows."""
    arrays, _, _ = _problem(6)
    inputs_j, inputs = _jax_inputs(arrays), _torch_inputs(arrays)
    if not run:
        inputs_j = inputs_j._replace(plans=inputs_j.plans._replace(
            harmonic_run=None))
        inputs = _drop_run(inputs)
    # quarter integers: every group sum and prefix sum is exact in f32, so
    # both packages convolve exactly and the comparison holds the plumbing
    # (JAX's segment sum otherwise rounds each group at a flat cumsum's
    # magnitude, ROADMAP Queue 3, which d ll / d ipred scales by 1 / sig^2)
    ipred = (np.random.default_rng(7).integers(-8, 17, N) / 4).astype(
        np.float32)
    j_lik, t_lik = LIKELIHOODS[lik]
    j_params = {k: np.float32(v) + np.float32(0.1 * i)
                for i, (k, v) in enumerate(sorted(j_lik.init().items()))}
    want, (g_p, g_v) = jax.value_and_grad(
        lambda p, v: j_lik.build(p, inputs_j).masked_ll_sum(v, None),
        argnums=(0, 1))(j_params, jnp.asarray(ipred))

    params = params_from_jax(j_params, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    v = torch.tensor(ipred, requires_grad=True)
    built = t_lik.build(params, inputs)
    assert (built.run_plan is not None) == run
    got = built.masked_ll_sum(v)
    keys = sorted(params)
    grads = torch.autograd.grad(got, [v] + [params[k] for k in keys])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    g_v = np.asarray(g_v)
    np.testing.assert_allclose(grads[0].numpy(), g_v, rtol=1e-5,
                               atol=1e-5 * np.abs(g_v).max())
    for k, g in zip(keys, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_p[k]), rtol=1e-4,
                                   err_msg=k)


def test_run_tail_counts_once_per_sample():
    """An (S, N) prediction adds the tail S times, as JAX's does; the
    port's ELBO passes one sample at a time, so the tail counts once per
    sample there."""
    arrays, _, _ = _problem(8)
    inputs_j, inputs = _jax_inputs(arrays), _torch_inputs(arrays)
    assert float(inputs.plans.harmonic_run.tail_mask.sum()) > 0
    j_lik, t_lik = LIKELIHOODS["normal_ev11"]
    ipred = np.random.default_rng(9).gamma(2.0, 1.0, (2, N)).astype(
        np.float32)
    want = float(j_lik.build(j_lik.init(), inputs_j).masked_ll_sum(
        jnp.asarray(ipred), None))
    built = t_lik.build(t_lik.init("cpu"), inputs)
    both = built.masked_ll_sum(torch.tensor(ipred)).item()
    each = sum(built.masked_ll_sum(torch.tensor(ipred[s])).item()
               for s in range(2))
    np.testing.assert_allclose(both, want, rtol=1e-5)
    np.testing.assert_allclose(each, want, rtol=1e-5)


ELBO_CASES = [(1, "normal", False), (2, "normal", True),
              (2, "normal_ev11", True)]


@pytest.mark.parametrize("mc,lik,stream", ELBO_CASES)
def test_laue_elbo_matches_jax(mc, lik, stream, monkeypatch):
    """The Laue ELBO, rebuilt on the JAX side from its public pieces
    (posterior, fused-trunk scaler, the chain plan_gather, the convolved
    likelihood's masked_ll_sum, the prior) at the same uniforms and noise
    as the port's elbo; `stream` lowers the VMEM cap in both packages so
    that the chain plan's backward permute streams (K5's plain version in
    the port)."""
    if stream:
        monkeypatch.setattr(jpg, "MAX_TABLE_ROWS", 8)
        monkeypatch.setattr(tpg, "MAX_TABLE_ROWS", 8)
    n_layers = 3
    arrays, asu, _ = _problem(10)
    centric = asu.centric
    prior, posterior, scaler = _jax_parts(centric, n_layers, D, N_IMAGES)
    j_lik, t_lik = LIKELIHOODS[lik]
    inputs_j, inputs = _jax_inputs(arrays), _torch_inputs(arrays)
    assert isinstance(inputs.plans.refl, tpg.ChainGatherPlan)
    assert inputs.plans.refl.inner.perm_plan.stream == stream
    rng = np.random.default_rng(11)
    params = {"posterior": posterior.init(np.asarray(prior.mean()),
                                          np.asarray(prior.stddev())),
              "scaler": scaler.init(jax.random.PRNGKey(0), D)}
    if j_lik.init():
        params["likelihood"] = j_lik.init()
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    key_f = jax.random.PRNGKey(12)
    u_f = np.asarray(jax.random.uniform(key_f, (mc, N_REFL), jnp.float32))
    eps = rng.standard_normal((mc, N)).astype(np.float32)

    def jax_loss(params):
        q = posterior.distribution(params["posterior"])
        z_f = q.sample(key_f, (mc,))
        sd = scaler.apply(params["scaler"], inputs_j)
        z_obs = jpg.plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = j_lik.build(params.get("likelihood", {}),
                         inputs_j).masked_ll_sum(ipred, None)
        kl = q.log_prob(z_f) - prior.log_prob(z_f)
        return -ll / mc + jnp.sum(kl) / mc

    loss_j, grads_j = jax.value_and_grad(jax_loss)(
        jax.tree.map(jnp.asarray, params))

    model = dataclasses.replace(_torch_model(centric, n_layers, D, N_IMAGES),
                                likelihood=t_lik, mc_samples=mc,
                                fused_kernel=True)
    assert not model._fused_eligible(inputs)   # Laue never takes K4
    p = params_from_jax(params, "cpu")
    named = flatten_params(p)
    leaves = [t.requires_grad_(True) for _, t in named]
    loss, _ = model.elbo(p, inputs, u_f=torch.tensor(u_f),
                         eps=torch.tensor(eps))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = jax.tree.leaves(grads_j)
    assert len(want) == len(grads)
    for (path, _), g, w in zip(named, grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), path


def test_run_and_convolve_elbo_agree(lowered_cap):
    """The run-aligned ELBO equals the one through plan_convolve (equal by
    construction, careless_tpu conv_runs.py:13-23), whose backward streams
    at the lowered cap; chip_smoke.py holds the same on the card."""
    arrays, asu, _ = _problem(13)
    model = dataclasses.replace(
        _torch_model(asu.centric, 2, D, N_IMAGES),
        likelihood=laue.NormalLikelihood())
    inputs = _torch_inputs(arrays)
    assert inputs.plans.harmonic.stream
    rng = np.random.default_rng(14)
    u_f = torch.tensor(rng.random(N_REFL).astype(np.float32))
    eps = torch.tensor(rng.standard_normal(N).astype(np.float32))
    params = DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                         _parser(mlp_layers=2), device="cpu").build_model()[1]
    out = []
    for ins in (inputs, _drop_run(inputs)):
        p = map_params(lambda t: t.detach().clone(), params)
        leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
        loss, _ = model.elbo(p, ins, u_f=u_f, eps=eps)
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("shape", [(), (3,)])
def test_convolve_on_the_run_plan_sums_each_group(shape):
    """ConvolvedLikelihood.convolve with a run plan (the outputs' harmonic
    sums): bucket g holds the sum of group g's rows, the other buckets 0,
    for (N,) and (S, N) values, within 2^-20 of the largest group sum of
    magnitudes of an f64 sum over the same rows (f32 adds of at most
    MAX_RUN terms); its gradient is the gather of the cotangent by
    harmonic_id, exactly."""
    arrays, _, _ = _problem(16)
    inputs = _torch_inputs(arrays)
    lik = laue.NormalLikelihood().build({}, inputs)
    assert lik.run_plan is not None and lik.run_plan.max_run >= 2
    rng = np.random.default_rng(17)
    v = torch.tensor(rng.standard_normal(shape + (N,)).astype(np.float32),
                     requires_grad=True)
    got = lik.convolve(v)
    hid = inputs.harmonic_id.long()

    def exact(x):
        return torch.zeros(x.shape[:-1] + (N,), dtype=torch.float64
                           ).index_add_(-1, hid, x.detach().double())
    bound = 2.0 ** -20 * exact(v.abs()).max().item()
    assert (got.detach().double() - exact(v)).abs().max().item() <= bound
    ct = torch.tensor(rng.standard_normal(shape + (N,)).astype(np.float32))
    (g,) = torch.autograd.grad(got, v, ct)
    assert torch.equal(g, ct[..., hid])


def _parser(**kw):
    import types
    return types.SimpleNamespace(**{**MONO_DEFAULTS, **kw})


def test_short_laue_training_run():
    """DataManager.build_model on Laue inputs picks the convolved Normal
    likelihood (the CLI defaults); 60 full-batch steps on the chain layout
    give a finite, falling loss."""
    arrays, asu, f_true = _problem(15)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                     _parser(mlp_layers=3), device="cpu")
    model, params, trainer = dm.build_model()
    assert type(model.likelihood) is laue.NormalLikelihood
    inputs = dm.inputs.sorted_by_harmonic(dm.n_refl).with_plans(
        dm.n_refl, dm.n_images)
    assert isinstance(inputs.plans.refl, tpg.ChainGatherPlan)
    trained, history = trainer.train(params, seeded_generator(0, "cpu"),
                                     inputs, 60, chunk_size=30, device="cpu")
    loss = np.asarray(history["loss"])
    assert len(loss) == 60 and np.isfinite(loss).all()
    assert loss[-10:].mean() < loss[:10].mean()
    mean = model.posterior.distribution(trained["posterior"]).mean()
    assert np.isfinite(mean.numpy()).all()


@pytest.mark.parametrize("refine,dof,cls", [
    (False, 4.0, laue.StudentTLikelihood),
    (True, None, laue.NormalEv11Likelihood),
    (True, 6.0, laue.StudentTEv11Likelihood),
])
def test_laue_likelihood_choice(refine, dof, cls):
    arrays, asu, _ = _problem(16, n=600, n_refl=80)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                     _parser(mlp_layers=2, refine_uncertainties=refine,
                             studentt_likelihood_dof=dof), device="cpu")
    model, params, _ = dm.build_model()
    assert type(model.likelihood) is cls
    assert ("likelihood" in params) == refine
