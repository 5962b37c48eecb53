"""The port's fused likelihood (K4's plain versions on the CPU) and the
multi-sample ELBO against careless_tpu.

JAX's fused_likelihood_sum runs its Pallas kernels in interpret mode with
supplied `noise`, as tests/ops/test_fused_elbo.py runs them; the port's runs
the plain forward and its explicit plain backward, the two functions K4
replaces on the card. Tolerances: the sum at rtol 1e-5 (f32 sums of ~700
terms); each gradient at the JAX file's rtol (2e-4, 3e-4 for the Ev11
kinds, :65-67 and :293-320) with its atol scaled by the tensor's largest
entry: the entries are differences (iobs - ipred, loc + scale eps) that
cancel, and XLA's CPU code and PyTorch's round the intermediate steps
differently, so an entry near 0 differs by ~1e-7 of the terms it cancels
(up to ~1e4 here), not by an absolute 2e-4. The table gradients da and
dzf are checked with one observation per entry (permuted ids) and with
repeated ids, where they are also sums taken in another order (the
planned segment sum against XLA's scatter-add). The explicit backward
against autograd of the plain forward in float64 at rtol 1e-10. The mc = 3
ELBO at rtol 1e-5, fused and unfused, against JAX's _elbo_fused and the
manual per-sample average of test_fused_elbo_multi_sample_matches_manual;
its gradients within 1e-4 of each tensor's largest entry, as in
tests/test_torch_elbo.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods import mono as jmono
from careless_tpu.models.merging.variational import \
    VariationalMergingModel as JModel
from careless_tpu.models.scaling.nn import MLPScaler as JMLP
from careless_tpu.ops.fused_elbo import \
    fused_likelihood_sum as jax_fused_likelihood_sum
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import mono
from careless_tpu_torch.models.merging.variational import (
    VariationalMergingModel, flatten_params)
from careless_tpu_torch.models.scaling.nn import MLPScaler
from careless_tpu_torch.ops.fused_elbo import (
    fused_likelihood_sum, plain_fused_likelihood_grads,
    plain_fused_likelihood_sum, plain_prng_normal)
from careless_tpu_torch.ops.plan_gather import make_gather_plan
from careless_tpu_torch.utils.params import params_from_jax
from tests.test_torch_elbo import _jax_parts, _problem, _torch_model

torch.set_num_threads(2)

KINDS = [("normal", 0.0), ("studentt", 4.0), ("laplace", 0.0),
         ("normal_ev11", 0.0), ("studentt_ev11", 5.0)]
EV = (1.3, 0.2, 0.7)


def _problem_arrays(seed=0, permuted=False):
    """tests/ops/test_fused_elbo.py's problem: 700 observations, 90
    reflections, 7 images, a mask with ~10 % zeros; `permuted` gives each
    observation a table entry of its own (700 reflections and images)."""
    rng = np.random.default_rng(seed)
    n, n_refl, n_img = 700, 90, 7
    if permuted:
        n_refl = n_img = n
    p = dict(
        loc=rng.normal(size=n).astype(np.float32),
        scale=(0.1 + rng.random(n)).astype(np.float32),
        a_tab=(0.5 + rng.random(n_img)).astype(np.float32),
        z_f=((0.1 + rng.random(n_refl)) * 3).astype(np.float32),
        refl_id=rng.integers(0, n_refl, n).astype(np.int32),
        image_id=rng.integers(0, n_img, n).astype(np.int32),
        iobs=rng.normal(2.0, 1.0, n).astype(np.float32),
        sig=(0.2 + rng.random(n)).astype(np.float32),
        mask=(rng.random(n) > 0.1).astype(np.float32),
        noise=rng.normal(size=n).astype(np.float32))
    if permuted:
        p["refl_id"] = rng.permutation(n).astype(np.int32)
        p["image_id"] = rng.permutation(n).astype(np.int32)
    return p


def _jax_sum(p, kind, dof):
    def f(loc, scale, a_tab, z_f, ev):
        return jax_fused_likelihood_sum(
            loc, scale, a_tab, z_f, p["refl_id"], p["image_id"], p["iobs"],
            p["sig"], p["mask"], seed=0, noise=p["noise"], kind=kind,
            dof=dof, ev11=ev if kind.endswith("_ev11") else None)
    args = (p["loc"], p["scale"], p["a_tab"], p["z_f"],
            tuple(jnp.float32(v) for v in EV))
    return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(*args)


def _torch_sum(p, kind, dof, mask=True, noise=True, seed=0, offset=0):
    t = {k: torch.tensor(v) for k, v in p.items()}
    leaves = [t[k].requires_grad_(True)
              for k in ("loc", "scale", "a_tab", "z_f")]
    ev = [torch.tensor(v, requires_grad=True) for v in EV]
    out = fused_likelihood_sum(
        t["loc"], t["scale"], t["a_tab"], t["z_f"], t["refl_id"],
        t["image_id"], t["iobs"], t["sig"], t["mask"] if mask else None,
        seed=seed, offset=offset, noise=t["noise"] if noise else None,
        refl_plan=make_gather_plan(t["refl_id"], len(p["z_f"])),
        image_plan=make_gather_plan(t["image_id"], len(p["a_tab"])),
        kind=kind, dof=dof, ev11=ev if kind.endswith("_ev11") else None)
    wrt = leaves + (ev if kind.endswith("_ev11") else [])
    return out, torch.autograd.grad(out, wrt)


@pytest.mark.parametrize("kind,dof", KINDS)
def test_forward_matches_jax(kind, dof):
    p = _problem_arrays()
    (want, _), (got, _) = _jax_sum(p, kind, dof), _torch_sum(p, kind, dof)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("permuted", [True, False])
@pytest.mark.parametrize("kind,dof", KINDS)
def test_gradients_match_jax(kind, dof, permuted):
    p = _problem_arrays(1, permuted)
    (_, g_jax), (_, g) = _jax_sum(p, kind, dof), _torch_sum(p, kind, dof)
    tol = 3e-4 if kind.endswith("_ev11") else 2e-4
    names = ["dloc", "dscale", "da", "dzf", "dev11"]
    want = list(g_jax[:4]) + ([np.stack([np.asarray(x) for x in g_jax[4]])]
                              if kind.endswith("_ev11") else [])
    got = list(g[:4]) + ([torch.stack(g[4:])] if kind.endswith("_ev11")
                         else [])
    assert len(got) == len(want)
    for a, b, name in zip(got, want, names):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=tol,
                                   atol=tol * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("kind,dof", KINDS)
def test_plain_backward_is_the_gradient_of_the_plain_forward(kind, dof):
    """K4-bwd's plain version against autograd of K4-fwd's, in float64."""
    p = _problem_arrays(2)
    rng = np.random.default_rng(3)
    d = {k: torch.tensor(p[k], dtype=torch.float64)
         for k in ("loc", "scale", "iobs", "sig", "mask", "noise")}
    a = torch.tensor(rng.uniform(-1.5, 1.5, 700))   # both signs of a
    f = torch.tensor(rng.uniform(0.2, 2.0, 700))
    ev = torch.tensor(EV, dtype=torch.float64)
    ins = [d["loc"], d["scale"], a, f]
    for x in ins + [ev]:
        x.requires_grad_(True)
    out = plain_fused_likelihood_sum(*ins, d["iobs"], d["sig"], d["mask"],
                                     ev, d["noise"], kind=kind, dof=dof)
    want = torch.autograd.grad(out, ins + [ev], allow_unused=True)
    ct = torch.tensor(0.75, dtype=torch.float64)
    got = plain_fused_likelihood_grads(
        *[x.detach() for x in ins], d["iobs"], d["sig"], d["mask"],
        ev.detach(), d["noise"], ct, kind=kind, dof=dof)
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, ct * w, rtol=1e-10, atol=1e-12)
    if kind.endswith("_ev11"):
        torch.testing.assert_close(got[4], ct * want[4], rtol=1e-10,
                                   atol=1e-12)
    else:
        assert got[4] is None


@pytest.mark.parametrize("kind,dof", [KINDS[0], KINDS[4]])
def test_philox_noise_is_k3s_stream(kind, dof):
    """Without `noise`, sample s draws K3's normals at counters
    [offset, offset + N): the same sum and gradients as with those normals
    supplied."""
    p = _problem_arrays(4)
    seed, offset = 0x5EED | (7 << 32), 3 * 700
    p_k3 = dict(p, noise=plain_prng_normal(700, seed, offset,
                                           "cpu").numpy())
    out, grads = _torch_sum(p, kind, dof, noise=False, seed=seed,
                            offset=offset)
    out_k3, grads_k3 = _torch_sum(p_k3, kind, dof)
    assert torch.equal(out, out_k3)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_k3))
    other, _ = _torch_sum(p, kind, dof, noise=False, seed=seed, offset=0)
    assert other.item() != out.item()


def test_mask_none_means_ones():
    p = _problem_arrays(5)
    out, grads = _torch_sum(dict(p, mask=np.ones(700, np.float32)),
                            "studentt_ev11", 5.0)
    out_none, grads_none = _torch_sum(p, "studentt_ev11", 5.0, mask=False)
    assert torch.equal(out, out_none)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_none))


def test_bad_kind_and_missing_scalars_raise():
    p = _problem_arrays()
    with pytest.raises(ValueError, match="unsupported"):
        _torch_sum(p, "cauchy", 0.0)
    t = {k: torch.tensor(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="ev11"):
        fused_likelihood_sum(
            t["loc"], t["scale"], t["a_tab"], t["z_f"], t["refl_id"],
            t["image_id"], t["iobs"], t["sig"], seed=0,
            refl_plan=make_gather_plan(t["refl_id"], 90),
            image_plan=make_gather_plan(t["image_id"], 7),
            kind="normal_ev11")


# ---------------------------------------------------------------------------
# the ELBO at mc = 3
# ---------------------------------------------------------------------------
LIKELIHOODS = {
    "normal": (jmono.NormalLikelihood(), mono.NormalLikelihood()),
    "laplace": (jmono.LaplaceLikelihood(), mono.LaplaceLikelihood()),
    "studentt": (jmono.StudentTLikelihood(4.0), mono.StudentTLikelihood(4.0)),
    "normal_ev11": (jmono.NormalEv11Likelihood(),
                    mono.NormalEv11Likelihood()),
    "studentt_ev11": (jmono.StudentTEv11Likelihood(4.0),
                      mono.StudentTEv11Likelihood(4.0)),
}
S = 3


def _elbo_case(lik, kl_weight=None, mlp_only=False):
    """(JAX model, its perturbed params, planned JAX inputs, the port's
    model and inputs, u_f (S, n_refl), noise (N,), JAX key)."""
    n, n_refl, n_images, d, n_layers = 1000, 100, 8, 4, 2
    arrays, centric, _ = _problem(n, n_refl, n_images, d, seed=11)
    prior, posterior, scaler = _jax_parts(centric, n_layers, d, n_images)
    if mlp_only:
        scaler = scaler.mlp
    j_lik, t_lik = LIKELIHOODS[lik]
    jmodel = JModel(posterior, prior, j_lik, scaler, mc_samples=S,
                    kl_weight=kl_weight, fused_kernel=True)
    inputs_j = JInputs.from_arrays(*arrays).sorted_by_refl().with_plans(
        n_refl, n_images, mlp_width=d)
    params = jmodel.init(jax.random.PRNGKey(0), inputs_j,
                         (np.asarray(prior.mean()),
                          np.asarray(prior.stddev())))
    rng = np.random.default_rng(12)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    key = jax.random.PRNGKey(5)
    k_f, _ = jax.random.split(key)
    u_f = np.asarray(jax.random.uniform(k_f, (S, n_refl), jnp.float32))
    noise = rng.standard_normal(n).astype(np.float32)

    tmodel = _torch_model(centric, n_layers, d, n_images, kl_weight)
    tmodel = dataclasses.replace(
        tmodel, likelihood=t_lik, mc_samples=S, fused_kernel=True,
        scaler=tmodel.scaler.mlp if mlp_only else tmodel.scaler)
    inputs = Inputs.from_arrays(*arrays, device="cpu").sorted_by_refl(
        ).with_plans(n_refl, n_images)
    return jmodel, params, inputs_j, tmodel, inputs, u_f, noise, key


def _manual_loss(jmodel, params, inputs_j, noise, key, kl_weight):
    """test_fused_elbo_multi_sample_matches_manual's per-sample average."""
    k_f, _ = jax.random.split(key)
    q = jmodel.posterior.distribution(params["posterior"])
    z_f = q.sample(k_f, (S,))
    if isinstance(jmodel.scaler, JMLP):
        sd = jmodel.scaler.apply(params["scaler"], inputs_j)
        z = sd.loc + sd.scale * noise
    else:
        sd = jmodel.scaler.mlp.apply(params["scaler"]["mlp"], inputs_j)
        a = jmodel.scaler.image.scales(
            params["scaler"]["image"])[inputs_j.image_id]
        z = a * sd.loc + jnp.abs(a) * sd.scale * noise
    lik = jmodel.likelihood.build(params.get("likelihood", {}), inputs_j)
    ll = sum(jnp.sum(lik.log_prob(z * jnp.square(z_f[s][inputs_j.refl_id])))
             for s in range(S)) / S
    kl = q.log_prob(z_f) - jmodel.prior.log_prob(z_f)
    if kl_weight is None:
        return -ll + jnp.sum(kl) / S
    return -ll / inputs_j.n_obs + kl_weight * jnp.mean(kl)


@pytest.mark.parametrize("lik,kl_weight,mlp_only", [
    ("normal", None, False), ("laplace", None, False),
    ("studentt", 0.5, False), ("normal_ev11", None, True),
    ("studentt_ev11", None, False), ("studentt_ev11", 0.5, False)])
@pytest.mark.parametrize("fused", [True, False])
def test_mc3_elbo_matches_jax(lik, kl_weight, mlp_only, fused):
    jmodel, params, inputs_j, tmodel, inputs, u_f, noise, key = _elbo_case(
        lik, kl_weight, mlp_only)
    loss_j, m_j = jmodel._elbo_fused(params, key, inputs_j,
                                     noise=jnp.asarray(noise))
    manual = _manual_loss(jmodel, params, inputs_j, noise, key, kl_weight)
    np.testing.assert_allclose(float(loss_j), float(manual), rtol=1e-5)
    tmodel = dataclasses.replace(tmodel, fused_kernel=fused)
    assert tmodel._fused_eligible(inputs) == fused
    loss, m = tmodel.elbo(params_from_jax(params, "cpu"), inputs,
                          u_f=torch.tensor(u_f),
                          eps=torch.tensor(np.tile(noise, (S, 1))))
    for name in ("loss", "NLL", "F KLDiv"):
        np.testing.assert_allclose(m[name].item(), float(m_j[name]),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(loss.item(), float(manual), rtol=1e-5)


@pytest.mark.parametrize("lik", ["normal", "studentt_ev11"])
def test_mc3_elbo_gradients_match_jax(lik):
    """Every parameter's gradient, the Ev11 raw scalars included, of the
    fused and the unfused ELBO against JAX's _elbo_fused."""
    jmodel, params, inputs_j, tmodel, inputs, u_f, noise, key = _elbo_case(
        lik)
    want = jax.tree.leaves(jax.grad(lambda p: jmodel._elbo_fused(
        p, key, inputs_j, noise=jnp.asarray(noise))[0])(
            jax.tree.map(jnp.asarray, params)))
    for fused in (True, False):
        model = dataclasses.replace(tmodel, fused_kernel=fused)
        p = params_from_jax(params, "cpu")
        named = flatten_params(p)
        leaves = [t.requires_grad_(True) for _, t in named]
        loss, _ = model.elbo(p, inputs, u_f=torch.tensor(u_f),
                             eps=torch.tensor(np.tile(noise, (S, 1))))
        grads = torch.autograd.grad(loss, leaves)
        assert len(grads) == len(want)
        if lik.endswith("_ev11"):
            assert [k for k, _ in named[:3]] == [
                "likelihood/sdadd_raw", "likelihood/sdb_raw",
                "likelihood/sdfac_raw"]
        for (path, _), g, w in zip(named, grads, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), \
                (fused, path)


def test_fused_and_unfused_draw_the_same_noise():
    """Without eps, both paths take sample s's normals from counters
    [s N, (s + 1) N) of the step's key: one estimator, on the CPU as on
    the card."""
    _, params, _, tmodel, inputs, u_f, _, _ = _elbo_case("studentt_ev11")
    p = params_from_jax(params, "cpu")
    losses = [dataclasses.replace(tmodel, fused_kernel=f).elbo(
        p, inputs, u_f=torch.tensor(u_f), seed=99 | (4 << 32))[0].item()
        for f in (True, False)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    other = tmodel.elbo(p, inputs, u_f=torch.tensor(u_f),
                        seed=99 | (5 << 32))[0].item()
    assert other != losses[0]


def test_mlp_scaler_alone_takes_the_fused_path():
    _, _, _, tmodel, inputs, _, _, _ = _elbo_case("normal", mlp_only=True)
    assert isinstance(tmodel.scaler, MLPScaler)
    assert tmodel._fused_eligible(inputs)
    assert not dataclasses.replace(
        tmodel, fused_kernel=False)._fused_eligible(inputs)
