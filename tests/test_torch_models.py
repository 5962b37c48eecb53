"""The port's model parts against careless_tpu's, with parameters carried
over by params_from_jax.

JAX parameters are built by the JAX classes' own init, perturbed with
numpy noise so that no layer stays the identity, exported as numpy and
converted. Tolerance rtol 1e-5: f32 closed forms, and the MLP's sums in
another order (the JAX trunk runs its interpret-mode Pallas kernel);
gradients within 1e-5 of each tensor's largest entry. With --mlp-dtype
bfloat16 the same tolerances hold at these narrow sizes, where no f32 sum
lands on the two sides of a bf16 rounding midpoint in the two packages
(tests/test_torch_fused_mlp.py explains the straddle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods.mono import NormalLikelihood as JLik
from careless_tpu.models.merging.surrogate import \
    TruncatedNormalPosterior as JPost
from careless_tpu.models.priors.wilson import WilsonPrior as JWilson
from careless_tpu.models.scaling.image import HybridImageScaler as JHybrid
from careless_tpu.models.scaling.image import ImageScaler as JImage
from careless_tpu.models.scaling.image import \
    NeuralImageScaler as JNeural
from careless_tpu.models.scaling.nn import MLPScaler as JMLP
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods.mono import NormalLikelihood
from careless_tpu_torch.models.merging.surrogate import \
    TruncatedNormalPosterior
from careless_tpu_torch.models.priors.wilson import WilsonPrior
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.models.scaling.image import (HybridImageScaler,
                                                     ImageScaler,
                                                     NeuralImageScaler)
from careless_tpu_torch.models.scaling.nn import MLPScaler
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy

torch.set_num_threads(2)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _arrays(n=900, n_refl=120, n_images=9, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_refl, n), rng.integers(0, n_images, n),
            np.zeros(n), rng.normal(size=(n, d)).astype(np.float32),
            rng.gamma(2.0, 1.0, n).astype(np.float32),
            rng.uniform(0.1, 0.5, n).astype(np.float32))


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.normal(size=np.shape(a)).astype(np.float32), tree)


def test_wilson_prior():
    rng = np.random.default_rng(1)
    centric = rng.random(200) < 0.3
    eps = rng.choice([1.0, 2.0, 4.0], 200).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, 200).astype(np.float32)
    x = rng.uniform(0.05, 4.0, 200).astype(np.float32)
    j = JWilson(centric, eps, sigma)
    t = WilsonPrior(torch.tensor(centric), torch.tensor(eps),
                    torch.tensor(sigma))
    _close(t.log_prob(torch.tensor(x)), j.log_prob(x))
    _close(t.mean(), j.mean())
    _close(t.stddev(), j.stddev())
    # scalar sigma, as the default (no --wilson-prior-b) builds it
    t1 = WilsonPrior(torch.tensor(centric), torch.tensor(eps), 1.0)
    _close(t1.log_prob(torch.tensor(x)), JWilson(centric, eps).log_prob(x))


def test_truncated_normal_posterior():
    rng = np.random.default_rng(2)
    centric = rng.random(100) < 0.2
    low = (1e-32 * ~centric).astype(np.float32)
    prior = JWilson(centric, np.ones(100, np.float32))
    loc, scale = np.asarray(prior.mean()), np.asarray(prior.stddev())
    jp = JPost(low=low, high=1e10, scale_shift=1e-7)
    tp = TruncatedNormalPosterior(low=torch.tensor(low), high=1e10,
                                  scale_shift=1e-7)
    j_params = jp.init(loc, scale)
    t_params = tp.init(loc, scale, "cpu")
    for k in ("loc_raw", "scale_raw"):
        np.testing.assert_array_equal(t_params[k].numpy(), j_params[k])
    params = _perturb(j_params, 3)
    jq = jp.distribution(params)
    tq = tp.distribution(params_from_jax(params, "cpu"))
    for name in ("mean", "stddev", "moment_4", "entropy"):
        _close(getattr(tq, name)(), getattr(jq, name)(), rtol=1e-4)


def test_normal_likelihood():
    arrays = _arrays()
    ipred = np.random.default_rng(4).gamma(2.0, 1.0, 900).astype(np.float32)
    j = JLik().build({}, JInputs.from_arrays(*arrays))
    t = NormalLikelihood().build({}, Inputs.from_arrays(*arrays,
                                                        device="cpu"))
    _close(t.log_prob(torch.tensor(ipred)), j.log_prob(ipred))


@pytest.mark.parametrize("bijector,shift", [("exp", None), ("softplus", None),
                                            ("softplus", 1.7), ("exp", 0.3)])
def test_mlp_scaler(bijector, shift):
    arrays = _arrays()
    jm = JMLP(3, 8, scale_bijector=bijector, scale_multiplier=shift)
    tm = MLPScaler(3, 8, scale_bijector=bijector, scale_multiplier=shift)
    j_params = jm.init(None, 6)
    np.testing.assert_array_equal(
        params_to_numpy(tm.init(6, "cpu"))["layers"][0]["w"],
        np.asarray(j_params["layers"][0]["w"]))
    params = _perturb(j_params, 5)
    jd = jm.apply(params, JInputs.from_arrays(*arrays))
    td = tm.apply(params_from_jax(params, "cpu"),
                  Inputs.from_arrays(*arrays, device="cpu"))
    _close(td.loc, jd.loc)
    _close(td.scale, jd.scale)


def test_hybrid_image_scaler():
    arrays = _arrays()
    n_refl, n_images = 120, 9
    jm = JHybrid(JMLP(3, 6, scale_bijector="exp"), JImage(n_images))
    tm = HybridImageScaler(MLPScaler(3, 6, scale_bijector="exp"),
                           ImageScaler(n_images))
    params = _perturb(jm.init(jax.random.PRNGKey(0), 6), 6)
    # negative image scales exercise |a|
    params["image"]["scales"][::2] *= -1.0
    j_in = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        n_refl, n_images, mlp_width=6)
    t_in = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(n_refl, n_images)
    np.testing.assert_array_equal(t_in.refl_id.numpy(), j_in.refl_id)
    jd = jm.apply(params, j_in)
    td = tm.apply(params_from_jax(params, "cpu"), t_in)
    _close(td.loc, jd.loc)
    _close(td.scale, jd.scale)


def _scaler_grads(jm, tm, params, arrays, seed=11):
    """Both scalers' (loc, scale) and the gradients of sum(loc c1 + scale
    c2) in every parameter, JAX's as numpy leaves in tree order."""
    n = len(arrays[0])
    rng = np.random.default_rng(seed)
    c1, c2 = rng.normal(size=(2, n)).astype(np.float32)
    j_in = JInputs.from_arrays(*arrays)

    def f(p):
        q = jm.apply(p, j_in)
        return jnp.sum(q.loc * c1) + jnp.sum(q.scale * c2), q
    (_, jd), j_grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    p = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    td = tm.apply(p, Inputs.from_arrays(*arrays, device="cpu"))
    grads = torch.autograd.grad((td.loc * torch.tensor(c1)).sum()
                                + (td.scale * torch.tensor(c2)).sum(),
                                leaves)
    want = jax.tree.leaves(j_grads)
    assert len(want) == len(grads)
    _close(td.loc, jd.loc)
    _close(td.scale, jd.scale)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("n_layers,mlp_dtype", [
    (3, "float32"), (3, "bfloat16"),   # K1 trunk-only, then the banks
    (1, "float32"), (1, "bfloat16"),   # the unfused layer loop
])
def test_neural_image_scaler(n_layers, mlp_dtype):
    """--image-layers 2: the shared trunk, two per-image banks gathered by
    unsorted image ids over 9 images, then the f32 head; the banks are
    perturbed from the identity so that each image's weights matter."""
    arrays = _arrays()
    n_images = 9
    jm = JNeural(2, n_images, JMLP(n_layers, 6, scale_bijector="exp",
                                   mlp_dtype=mlp_dtype))
    tm = NeuralImageScaler(2, n_images, MLPScaler(
        n_layers, 6, scale_bijector="exp", mlp_dtype=mlp_dtype))
    j_params = jm.init(None, 6)
    t_params = params_to_numpy(tm.init(6, "cpu"))
    assert jax.tree.structure(t_params) == jax.tree.structure(j_params)
    for a, b in zip(jax.tree.leaves(t_params), jax.tree.leaves(j_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert np.unique(arrays[1]).size == n_images
    assert np.any(np.diff(arrays[1]) < 0)
    _scaler_grads(jm, tm, _perturb(j_params, 13), arrays)


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [0, 1])
def test_mlp_scaler_without_the_kernel(n_layers, mlp_dtype):
    """--mlp-layers 0 and 1: JAX runs no kernel there (the layer loop,
    bf16 through `_mm`'s casts, then an f32 head); nor does the port."""
    arrays = _arrays()
    jm = JMLP(n_layers, 6, scale_bijector="exp", mlp_dtype=mlp_dtype)
    tm = MLPScaler(n_layers, 6, scale_bijector="exp", mlp_dtype=mlp_dtype)
    _scaler_grads(jm, tm, _perturb(jm.init(None, 6), 13), arrays)


def test_mlp_scaler_bf16_differs_from_f32():
    """bf16 products move the scales far past the tolerance above."""
    arrays = _arrays()
    params = params_from_jax(_perturb(JMLP(3, 6).init(None, 6), 14), "cpu")
    inputs = Inputs.from_arrays(*arrays, device="cpu")
    loc = [MLPScaler(3, 6, mlp_dtype=t).apply(params, inputs).loc
           for t in ("float32", "bfloat16")]
    assert (loc[0] - loc[1]).abs().max() > 1e-3 * loc[0].abs().max()


def test_params_round_trip_image_layers():
    """The --image-layers banks carry across from a JAX tree leaf for
    leaf, beside the MLP's."""
    jm = JNeural(2, 7, JMLP(4, 5))
    tree = {"posterior": {"loc_raw": np.arange(3, dtype=np.float32),
                          "scale_raw": -np.ones(3, np.float32)},
            "scaler": _perturb(jm.init(None, 5), 15)}
    p = params_from_jax(tree, "cpu")
    assert p["scaler"]["image_layers"][1]["w"].shape == (7, 5, 5)
    assert p["scaler"]["image_layers"][1]["b"].shape == (7, 5)
    back = params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_params_round_trip():
    jm = JHybrid(JMLP(4, 5), JImage(7))
    tree = {"posterior": {"loc_raw": np.arange(3, dtype=np.float32),
                          "scale_raw": -np.ones(3, np.float32)},
            "scaler": _perturb(jm.init(jax.random.PRNGKey(1), 5), 8)}
    back = params_to_numpy(params_from_jax(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_inputs_select_and_plans_follow_the_rows():
    if torch.cuda.is_available():
        assert Inputs.from_arrays(*_arrays()).device.type == "cuda"
    else:
        # device=None means the card; without one it raises, never the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Inputs.from_arrays(*_arrays())
    inputs = Inputs.from_arrays(*_arrays(), device="cpu")
    planned = inputs.sorted_by_refl().with_plans(120, 9)
    assert planned.plans.refl.perm is None
    assert planned.plans.image.perm is not None
    assert planned.select(planned.image_id < 4).plans is None
    assert planned.to("cpu") is planned
    # plans use the GLOBAL sizes, not the subset's own maximum id
    half = planned.select(planned.image_id < 4).with_plans(120, 9)
    assert half.plans.image.starts.shape == (9,)
    assert half.plans.refl.starts.shape == (120,)
