"""The ported slice as a whole: the mono ELBO, Adam and a short training
run, against careless_tpu.

The JAX `elbo` draws its noise inside, so the reference loss is rebuilt
from the public JAX pieces (posterior.distribution, scaler.apply through
the fused trunk, plan_gather, likelihood.build, prior.log_prob) at the same
reflection uniforms (jax.random.uniform of the key its sample uses) and
the same scale noise eps. Tolerances: the loss is an f32 sum of ~2000
terms (rtol 1e-5); each gradient tensor within 1e-4 of its largest entry
(sums over observations in other orders, the MLP through 3 layers); Adam
against optax within f32 rounding of the update (atol 1e-7 on O(1)
parameters).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods.mono import NormalLikelihood as JLik
from careless_tpu.models.merging.surrogate import \
    TruncatedNormalPosterior as JPost
from careless_tpu.models.merging.variational import Trainer as JTrainer
from careless_tpu.models.merging.variational import \
    VariationalMergingModel as JModel
from careless_tpu.models.priors.wilson import WilsonPrior as JWilson
from careless_tpu.models.scaling.image import HybridImageScaler as JHybrid
from careless_tpu.models.scaling.image import ImageScaler as JImage
from careless_tpu.models.scaling.image import \
    NeuralImageScaler as JNeural
from careless_tpu.models.scaling.nn import MLPScaler as JMLP
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import mono
from careless_tpu_torch.models.likelihoods.mono import NormalLikelihood
from careless_tpu_torch.models.merging.surrogate import \
    TruncatedNormalPosterior
from careless_tpu_torch.models.merging.variational import (
    Trainer, VariationalMergingModel, flatten_params)
from careless_tpu_torch.models.priors.wilson import WilsonPrior
from careless_tpu_torch.models.scaling.image import (HybridImageScaler,
                                                     ImageScaler)
from careless_tpu_torch.models.scaling.nn import MLPScaler
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy

torch.set_num_threads(2)


def _problem(n, n_refl, n_images, d, seed):
    """bench.py's synthetic mono problem at a small size."""
    rng = np.random.default_rng(seed)
    refl_id = rng.integers(0, n_refl, n)
    image_id = rng.integers(0, n_images, n)
    metadata = rng.normal(size=(n, d)).astype(np.float32)
    f_true = np.abs(rng.normal(1.0, 0.5, n_refl)) + 0.05
    iobs = np.exp(0.2 * metadata[:, 0]) * f_true[refl_id] ** 2
    iobs = iobs + 0.1 * np.sqrt(np.abs(iobs)) * rng.normal(size=n)
    sig = np.full(n, 0.1, np.float32)
    centric = rng.random(n_refl) < 0.2
    arrays = (refl_id, image_id, np.zeros(n), metadata, iobs, sig)
    return arrays, centric, f_true


def _jax_parts(centric, n_layers, d, n_images, fused=True):
    prior = JWilson(centric, np.ones(len(centric), np.float32))
    posterior = JPost(low=(1e-32 * ~centric).astype(np.float32))
    scaler = JHybrid(JMLP(n_layers, d, scale_bijector="exp", fused=fused),
                     JImage(n_images))
    return prior, posterior, scaler


def _torch_model(centric, n_layers, d, n_images, kl_weight=None):
    prior = WilsonPrior(torch.tensor(centric),
                        torch.ones(len(centric)), 1.0)
    posterior = TruncatedNormalPosterior(
        low=torch.tensor((1e-32 * ~centric).astype(np.float32)))
    scaler = HybridImageScaler(MLPScaler(n_layers, d, scale_bijector="exp"),
                               ImageScaler(n_images))
    return VariationalMergingModel(posterior, prior, NormalLikelihood(),
                                   scaler, kl_weight=kl_weight)


@pytest.mark.parametrize("kl_weight", [None, 0.5])
def test_elbo_loss_and_gradients_match_jax(kl_weight):
    n, n_refl, n_images, d, n_layers = 2000, 150, 12, 5, 3
    arrays, centric, _ = _problem(n, n_refl, n_images, d, seed=0)
    prior, posterior, scaler = _jax_parts(centric, n_layers, d, n_images)
    rng = np.random.default_rng(1)
    params = {"posterior": posterior.init(np.asarray(prior.mean()),
                                          np.asarray(prior.stddev())),
              "scaler": scaler.init(jax.random.PRNGKey(0), d)}
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    inputs_j = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        n_refl, n_images, mlp_width=d)
    key_f = jax.random.PRNGKey(5)
    u_f = np.asarray(jax.random.uniform(key_f, (n_refl,), jnp.float32))
    eps = rng.standard_normal(n).astype(np.float32)

    def jax_loss(params):
        q = posterior.distribution(params["posterior"])
        z_f = q.sample(key_f)
        sd = scaler.apply(params["scaler"], inputs_j)
        z_obs = jax_plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = JLik().build({}, inputs_j).log_prob(ipred).sum()
        kl = q.log_prob(z_f) - prior.log_prob(z_f)
        if kl_weight is None:       # variational.py:220-229
            return -ll + jnp.sum(kl)
        return -ll / n + kl_weight * jnp.mean(kl)

    loss_j, grads_j = jax.value_and_grad(jax_loss)(
        jax.tree.map(jnp.asarray, params))

    model = _torch_model(centric, n_layers, d, n_images, kl_weight)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(n_refl, n_images)
    p = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    loss, metrics = model.elbo(p, inputs, u_f=torch.tensor(u_f),
                               eps=torch.tensor(eps))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    torch.testing.assert_close(
        metrics["NLL"] + (kl_weight or 1.0) * metrics["F KLDiv"], loss)
    want = jax.tree.leaves(grads_j)
    assert len(want) == len(grads) == 2 + 2 * n_layers + 2 + 1
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


OPTIONS = [{}, {"clipnorm": 0.5}, {"clipvalue": 0.05},
           {"global_clipnorm": 0.3}]


@pytest.mark.parametrize("opts", OPTIONS)
def test_adam_steps_match_optax(opts):
    """Same gradient sequence through the JAX trainer's optax chain and the
    port's transform + torch.optim.Adam; step 2 holds NaN and inf, which
    the norm reports and the update ignores."""
    rng = np.random.default_rng(2)
    params = {"posterior": {"loc_raw": rng.normal(size=6),
                            "scale_raw": rng.normal(size=6)},
              "scaler": {"w": rng.normal(size=(3, 3)), "b": rng.normal(size=3)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    grad_seq = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params) for _ in range(6)]
    grad_seq[2]["posterior"]["loc_raw"][1] = np.nan
    grad_seq[2]["scaler"]["w"][0, 2] = np.inf

    jt = JTrainer(None, **opts)
    opt = jt.optimizer()
    pj = jax.tree.map(jnp.asarray, params)
    state = opt.init(pj)
    norms_j = []
    for g in grad_seq:
        flat = jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(g)])
        norms_j.append(float(jnp.sqrt(jnp.sum(jnp.square(flat)))))
        g = jax.tree.map(lambda x: jnp.where(jnp.isfinite(x), x, 0.0), g)
        updates, state = opt.update(g, state, pj)
        pj = optax.apply_updates(pj, updates)

    tt = Trainer(None, **opts)
    p = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    topt = tt.optimizer(leaves)
    norms = []
    for g in grad_seq:
        gs = [torch.tensor(x) for x in jax.tree.leaves(g)]
        gs, norm = tt.transform_grads(gs, [False] * len(gs))
        norms.append(norm.item())
        for leaf, gl in zip(leaves, gs):
            leaf.grad = gl
        topt.step()
    np.testing.assert_allclose(norms, norms_j, rtol=1e-6)
    assert np.isnan(norms[2])
    for a, b in zip(jax.tree.leaves(params_to_numpy(p)),
                    jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


def _parser(**kw):
    ns = dict(wilson_prior_b=None, structure_factor_init_scale=1.0,
              epsilon=1e-7, mlp_layers=4, mlp_width=None,
              scale_bijector="exp", use_image_scales=True, kl_weight=None,
              learning_rate=1e-3, beta_1=0.9, beta_2=0.99, clipnorm=None,
              clipvalue=None, global_clipnorm=None)
    ns.update(kw)
    return types.SimpleNamespace(**ns)


def _asu(centric):
    n = len(centric)
    return types.SimpleNamespace(centric=centric,
                                 multiplicity=np.ones(n, np.float32),
                                 dHKL=np.linspace(1.5, 4.0, n))


def test_short_training_run_tracks_jax():
    """300 full-batch steps of the port (plain versions on the CPU) beside
    careless_tpu's Trainer.train on the same problem. The noise streams
    differ, so the comparison is statistical: the posterior means of the
    two runs correlate (measured 0.956; the bar is 0.9), and the port's
    with the true amplitudes (measured 0.824, JAX's 0.831; the bar 0.75)."""
    n, n_refl, n_images, d, n_layers, steps = 3000, 200, 10, 4, 4, 300
    arrays, centric, f_true = _problem(n, n_refl, n_images, d, seed=3)

    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric), _parser(mlp_layers=n_layers),
                     device="cpu")
    model, params, trainer = dm.build_model()
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    trained, history = trainer.train(params, seeded_generator(0, "cpu"),
                                     inputs, steps, chunk_size=100,
                                     device="cpu")
    loss = np.asarray(history["loss"])
    assert len(loss) == steps and np.isfinite(loss).all()
    assert loss[-50:].mean() < loss[:50].mean()
    mean_t = model.posterior.distribution(
        trained["posterior"]).mean().numpy()

    prior, posterior, scaler = _jax_parts(centric, n_layers, d, n_images,
                                          fused=False)
    jmodel = JModel(posterior, prior, JLik(), scaler)
    jparams = jmodel.init(jax.random.PRNGKey(0), JInputs.from_arrays(*arrays),
                          (np.asarray(prior.mean()),
                           np.asarray(prior.stddev())))
    # both packages start from the same parameters (the prior's moments
    # through each library's lgamma/sqrt: a few ulp)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)
    jtrained, _ = JTrainer(jmodel).train(
        jparams, jax.random.PRNGKey(0), JInputs.from_arrays(*arrays), steps,
        progress=False)
    mean_j = np.asarray(jmodel.posterior.distribution(
        jtrained["posterior"]).mean())
    assert np.corrcoef(mean_t, mean_j)[0, 1] > 0.9
    assert np.corrcoef(mean_t, f_true)[0, 1] > 0.75


def test_frozen_subtree_does_not_move():
    arrays, centric, _ = _problem(500, 40, 4, 3, seed=4)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric), _parser(mlp_layers=2), device="cpu")
    model, params, _ = dm.build_model()
    trainer = Trainer(model, freeze=("scaler",))
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    trained, _ = trainer.train(params, seeded_generator(1, "cpu"), inputs, 5,
                               device="cpu")
    for a, b in zip(jax.tree.leaves(params_to_numpy(trained["scaler"])),
                    jax.tree.leaves(params_to_numpy(params["scaler"]))):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(trained["posterior"]["loc_raw"].numpy(),
                              params["posterior"]["loc_raw"].numpy())


def test_entry_points_default_to_the_card():
    arrays, centric, _ = _problem(200, 20, 3, 3, seed=5)
    inputs = Inputs.from_arrays(*arrays, device="cpu")
    if torch.cuda.is_available():
        assert DataManager(inputs, _asu(centric)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataManager(inputs, _asu(centric), _parser())
    dm = DataManager(inputs, _asu(centric), _parser(mlp_layers=2),
                     device="cpu")
    model, params, trainer = dm.build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(params, seeded_generator(0, "cpu"),
                      dm.inputs.with_plans(dm.n_refl, dm.n_images), 1)


def test_without_image_scales_the_mlp_scales_alone():
    arrays, centric, _ = _problem(400, 30, 3, 3, seed=8)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric), _parser(mlp_layers=2,
                                            use_image_scales=False),
                     device="cpu")
    model, params, trainer = dm.build_model()
    assert isinstance(model.scaler, MLPScaler)
    assert set(params["scaler"]) == {"layers", "out"}
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    _, history = trainer.train(params, seeded_generator(2, "cpu"), inputs,
                               3, device="cpu")
    assert np.isfinite(history["loss"]).all()


def test_wilson_b_and_softplus_options_build():
    """--wilson-prior-b and --scale-bijector softplus are ported: the prior
    gets sigma(B) = exp(-B / 4d^2) and the MLP's loc the std shift."""
    arrays, centric, _ = _problem(300, 20, 3, 3, seed=7)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric),
                     _parser(mlp_layers=2, wilson_prior_b=20.0,
                             scale_bijector="softplus"), device="cpu")
    model, params, _ = dm.build_model()
    d_hkl = _asu(centric).dHKL
    np.testing.assert_allclose(model.prior.sigma.numpy(),
                               np.exp(-5.0 / d_hkl ** 2), rtol=1e-6)
    assert model.scaler.mlp.scale_multiplier == pytest.approx(
        float(np.std(np.asarray(arrays[4], np.float32))))


@pytest.mark.parametrize("flag,mc,n,fused", [
    ("auto", 1, 500_000, False), ("auto", 2, 499_999, False),
    ("auto", 2, 500_000, True), (None, 3, 600_000, True),
    ("on", 1, 200, True), ("on", 2, 200, True), ("off", 2, 500_000, False),
])
def test_fused_kernel_policy(flag, mc, n, fused):
    """careless_tpu/io/manager.py:170-175: 'auto' (the default) takes K4 at
    mc > 1 from 500k observations; 'on' and 'off' force it."""
    rng = np.random.default_rng(9)
    arrays = (rng.integers(0, 20, n), rng.integers(0, 3, n), np.zeros(n),
              np.zeros((n, 1), np.float32), np.ones(n), np.ones(n))
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(np.zeros(20, bool)),
                     _parser(mlp_layers=1, mc_samples=mc, fused_kernel=flag),
                     device="cpu")
    model, _, _ = dm.build_model()
    assert model.mc_samples == mc and model.fused_kernel is fused


@pytest.mark.parametrize("dof,refine,cls,kind", [
    (None, False, mono.NormalLikelihood, "normal"),
    (4.0, False, mono.StudentTLikelihood, "studentt"),
    (None, True, mono.NormalEv11Likelihood, "normal_ev11"),
    (6.0, True, mono.StudentTEv11Likelihood, "studentt_ev11"),
])
def test_likelihood_choice(dof, refine, cls, kind):
    """careless_tpu/io/manager.py:130-137, with the Ev11 raw scalars at
    softplus^-1(1) in params["likelihood"]."""
    arrays, centric, _ = _problem(300, 20, 3, 3, seed=10)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric),
                     _parser(mlp_layers=2, studentt_likelihood_dof=dof,
                             refine_uncertainties=refine), device="cpu")
    model, params, _ = dm.build_model()
    assert type(model.likelihood) is cls
    assert model._fused_likelihood_kind() == (kind, dof or 0.0)
    if refine:
        assert sorted(params["likelihood"]) == ["sdadd_raw", "sdb_raw",
                                                "sdfac_raw"]
        for v in params["likelihood"].values():
            assert v.shape == () and v.item() == pytest.approx(
                mono.SOFTPLUS_INV_1)
    else:
        assert "likelihood" not in params


@pytest.mark.parametrize("fused", ["on", "off"])
def test_short_mc2_ev11_training_run(fused):
    """--mc-samples=2 --studentt-likelihood-dof=4 --refine-uncertainties,
    fused and unfused: 60 steps with a finite, falling loss, and the Ev11
    scalars move. Both paths draw the same noise, so they train alike."""
    arrays, centric, _ = _problem(1500, 100, 6, 4, seed=12)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric),
                     _parser(mlp_layers=3, mc_samples=2,
                             studentt_likelihood_dof=4.0,
                             refine_uncertainties=True, fused_kernel=fused),
                     device="cpu")
    model, params, trainer = dm.build_model()
    assert model.fused_kernel is (fused == "on")
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    trained, history = trainer.train(params, seeded_generator(3, "cpu"),
                                     inputs, 60, chunk_size=30, device="cpu")
    loss = np.asarray(history["loss"])
    assert len(loss) == 60 and np.isfinite(loss).all()
    assert loss[-10:].mean() < loss[:10].mean()
    for k, v in trained["likelihood"].items():
        assert np.isfinite(v.item())
        assert v.item() != params["likelihood"][k].item()


SCALER_FLAGS = [{"image_layers": 2}, {"mlp_dtype": "bfloat16"},
                {"image_layers": 2, "mlp_dtype": "bfloat16"}]


@pytest.mark.parametrize("flags", SCALER_FLAGS)
def test_scaler_flags_elbo_matches_jax(flags):
    """--image-layers 2 (NeuralImageScaler: K1 trunk-only, two per-image
    banks, the f32 head) and --mlp-dtype bfloat16, built by build_model:
    the loss and every gradient against the JAX pieces' ELBO (as above) at
    the same parameters, uniforms and noise, with the same tolerances."""
    _hold_built_model_against_jax(flags)


def test_wide_mlp_elbo_matches_jax():
    """--mlp-width 64 (past csrc/trunk.cu's 32; csrc/trunk_wide.cu's on the
    card), built by build_model, against the JAX pieces' ELBO as above."""
    _hold_built_model_against_jax({"mlp_width": 64})


def _hold_built_model_against_jax(flags):
    n, n_refl, n_images, d, n_layers = 2000, 150, 12, 5, 4
    width = flags.get("mlp_width", d)
    arrays, centric, _ = _problem(n, n_refl, n_images, d, seed=20)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric), _parser(mlp_layers=n_layers, **flags),
                     device="cpu")
    model, params, _ = dm.build_model()
    dtype = flags.get("mlp_dtype", "float32")
    assert model.scaler.__class__.__name__ == (
        "NeuralImageScaler" if "image_layers" in flags
        else "HybridImageScaler")
    jmlp = JMLP(n_layers, width, scale_bijector="exp", mlp_dtype=dtype)
    scaler = (JNeural(2, n_images, jmlp) if "image_layers" in flags
              else JHybrid(jmlp, JImage(n_images)))
    prior = JWilson(centric, np.ones(n_refl, np.float32))
    posterior = JPost(low=(1e-32 * ~centric).astype(np.float32))
    rng = np.random.default_rng(21)
    start = jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params_to_numpy(params))
    inputs_j = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        n_refl, n_images, mlp_width=width)
    key_f = jax.random.PRNGKey(6)
    u_f = np.asarray(jax.random.uniform(key_f, (n_refl,), jnp.float32))
    eps = rng.standard_normal(n).astype(np.float32)

    def jax_loss(params):
        q = posterior.distribution(params["posterior"])
        z_f = q.sample(key_f)
        sd = scaler.apply(params["scaler"], inputs_j)
        z_obs = jax_plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = JLik().build({}, inputs_j).log_prob(ipred).sum()
        return -ll + jnp.sum(q.log_prob(z_f) - prior.log_prob(z_f))

    loss_j, grads_j = jax.value_and_grad(jax_loss)(
        jax.tree.map(jnp.asarray, start))
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    p = params_from_jax(start, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    loss, _ = model.elbo(p, inputs, u_f=torch.tensor(u_f),
                         eps=torch.tensor(eps))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = jax.tree.leaves(grads_j)
    assert len(want) == len(grads)
    assert params["scaler"]["mlp"]["layers"][0]["w"].shape == (d, width)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("flags", SCALER_FLAGS)
def test_scaler_flags_train(flags):
    """A few steps of each flag set train: finite, falling losses, and the
    image banks move (--image-layers)."""
    arrays, centric, _ = _problem(1500, 100, 6, 4, seed=22)
    dm = DataManager(Inputs.from_arrays(*arrays, device="cpu"),
                     _asu(centric), _parser(mlp_layers=3, **flags),
                     device="cpu")
    model, params, trainer = dm.build_model()
    inputs = dm.inputs.sorted_by_refl().with_plans(dm.n_refl, dm.n_images)
    trained, history = trainer.train(params, seeded_generator(4, "cpu"),
                                     inputs, 40, chunk_size=20,
                                     device="cpu")
    loss = np.asarray(history["loss"])
    assert len(loss) == 40 and np.isfinite(loss).all()
    assert loss[-10:].mean() < loss[:10].mean()
    if "image_layers" in flags:
        banks = trained["scaler"]["image_layers"]
        assert len(banks) == 2 and banks[0]["w"].shape == (6, 4, 4)
        assert not torch.equal(banks[0]["w"],
                               params["scaler"]["image_layers"][0]["w"])
