"""Half-dataset crossvalidation (--merge-half-datasets) and the frozen-leaf
gradient of the port's Trainer, against careless_tpu, on the CPU.

The port's halves over two repeats are the JAX package's rows, field for
field (mono, and Laue with its groups renumbered and repacked). A 3-step
`mono ... --merge-half-datasets --half-dataset-repeats=2` run of each CLI
in each --xval-mode writes the same _xval_0.mtz: columns, MTZ types and
(H, K, L, repeat, half) rows; the port's two forms write it bit for bit. From the same parameters, uniforms and scale
noise, each half's loss in the parallel form's one pass over the stacked
halves (parallel/xval.py halves_elbo) equals the JAX package's for that
half alone at rtol 1e-5, and its posterior gradient within 1e-4 of each
tensor's largest entry (test_torch_elbo.py's bar: the JAX package's
segment sum differences a flat f32 cumsum; measured 1.5e-5), mono and
Laue. The parallel form equals the serial form (each half trained by
Trainer.train with its own seeded generator) after 3 steps: mono, Laue,
--analytic-kl, the double-Wilson prior with r trained, mc = 2 through K4
with the Student-t Ev11 likelihood, and Laue Ev11, each half's parameters
bit for bit (the blocked segment sum takes each half's sums in its serial
order); mono Ev11 at mc = 2 unfused at rtol 1e-4 (its scalars' gradient
sums rows and samples in another order); every history (loss, NLL, KL,
rDW, Grad Norm) at rtol 1e-5 (those sum rows and leaves in rows of K).
Under --global-clipnorm, which a norm over all halves would couple, the
same at rtol 1e-5 (each half's norm may round otherwise). A half made
non-finite is reported and the others train on, bit for bit their serial
runs. The blocked segment sum equals each block's own plan's bit for bit.
A frozen subtree takes no backward, yet parameters and history are bit
for bit those of the step that asked autograd for every leaf and zeroed
the frozen ones.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import careless_tpu_torch.models.scaling.nn as port_nn
import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io.manager import DataManager as JDataManager
from careless_tpu.main import main as jax_main
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import (flatten_params,
                                                           map_params)
from careless_tpu_torch.parallel.xval import (half_params, halves_elbo,
                                              make_half_keys, stack_halves,
                                              train_halves)
from careless_tpu_torch.utils.params import params_from_jax
from careless_tpu_torch.xtal import read_mtz
from tests.test_torch_test_fraction import _same_rows

torch.set_num_threads(2)

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,XDET"
XVAL = ["--iterations=3", "--mlp-layers=2", "--disable-progress-bar",
        "--merge-half-datasets", "--half-dataset-repeats=2"]


def _managers(laue, seed=3, n=2400, n_refl=300, n_images=12, d=4, **flags):
    arrays, asu, _ = chip_smoke.build_problem(seed, n, n_refl, n_images, d,
                                              laue=laue)
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed,
                                      **flags})
    return (DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                        parser, device="cpu"),
            JDataManager(JInputs.from_arrays(*arrays), asu, parser))


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_halves_over_two_repeats_are_the_jax_rows(laue):
    """The serial loop's draws, a split per repeat from the manager's
    generator: every field of every half equal to the JAX package's."""
    port, jax_dm = _managers(laue)
    for _ in range(2):
        got, want = port.split_data_by_image(), jax_dm.split_data_by_image()
        for g, w in zip(got, want):
            _same_rows(g, w)
        assert got[0].n_obs + got[1].n_obs == port.inputs.n_obs
        assert min(g.n_obs for g in got) > 0


@pytest.fixture(scope="module")
def cli_xval(tmp_path_factory):
    """Each CLI's 3-step run in each --xval-mode on one seeded MTZ."""
    d = tmp_path_factory.mktemp("xval")
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(7, 3000, 30, CELL,
                                                    "P 63", 3.0)
    mtz = str(d / "in.mtz")
    jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                            spacegroup=jx.SpaceGroup.from_name("P 63"),
                            mtz_dtypes=types_), mtz)
    out = {}
    for mode in ("serial", "parallel"):
        argv = ["mono", KEYS, mtz, None, *XVAL, f"--xval-mode={mode}"]
        for pkg, run, extra in (("jax", jax_main, []),
                                ("port", port_main, ["--disable-gpu"])):
            argv[3] = out[pkg, mode] = str(d / f"{pkg}_{mode}")
            run(argv + extra)
    return out


@pytest.mark.parametrize("mode", ["serial", "parallel"])
def test_cli_writes_the_jax_xval_file(cli_xval, mode):
    port, want = (read_mtz(cli_xval[p, mode] + "_xval_0.mtz")
                  for p in ("port", "jax"))
    assert port.columns == want.columns and port.columns[-2:] == [
        "repeat", "half"]
    assert port.mtz_dtypes == want.mtz_dtypes
    assert port.mtz_dtypes["repeat"] == port.mtz_dtypes["half"] == "I"
    assert len(port) == len(want) > 100
    for c in ("H", "K", "L", "repeat", "half"):
        np.testing.assert_array_equal(port[c], want[c], err_msg=c)
    assert set(zip(port["repeat"], port["half"])) == {
        (r, h) for r in (0, 1) for h in (0, 1)}
    assert np.isfinite(port["F"]).all() and np.isfinite(port["SigF"]).all()


def test_the_port_xval_forms_agree_on_the_cli(cli_xval):
    """The two forms' files bit for bit, every column (the JAX package
    holds its own two forms to rtol 1e-3, tests/parallel/test_xval.py)."""
    a, b = (read_mtz(cli_xval["port", m] + "_xval_0.mtz")
            for m in ("serial", "parallel"))
    assert a.columns == b.columns and len(a) == len(b)
    for c in a.columns:
        assert a[c].tobytes() == b[c].tobytes(), c


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_blocked_segment_sum_is_each_blocks_own(laue):
    """The stacked refl plan's backward (ops/plan_gather.py block_plan) on
    a cotangent of values over seven decades: each half's table entries
    equal its own plan's segment sum bit for bit, and the unblocked sum
    over the concatenation does not."""
    from careless_tpu_torch.ops.plan_gather import (ChainGatherPlan,
                                                    segment_sum_by_plan)
    port, _ = _managers(laue, n=6000)
    halves = port.split_data_by_image() + port.split_data_by_image()
    stacked = stack_halves([port.planned_rows(h).inputs for h in halves],
                           port.n_refl, port.n_images)

    def inner(plan):
        return plan.inner if isinstance(plan, ChainGatherPlan) else plan
    plan = inner(stacked.inputs.plans.refl)
    assert plan.blocks is not None and plan.blocks.count == 4
    rng = np.random.default_rng(9)
    parts = [torch.tensor((rng.normal(size=h.n_obs) * 10.0 ** rng.uniform(
        -3, 4, h.n_obs)).astype(np.float32)) for h in halves]
    got = segment_sum_by_plan(torch.cat(parts), plan).view(4, -1)
    for k, (c, h) in enumerate(zip(parts, halves)):
        own = inner(port.planned_inputs(h).inputs.plans.refl)
        assert torch.equal(got[k], segment_sum_by_plan(c, own)), k
    unblocked = inner(stacked.inputs.replace(plans=None).with_plans(
        4 * port.n_refl, port.n_images).plans.refl)
    assert unblocked.blocks is None
    again = segment_sum_by_plan(torch.cat(parts), unblocked).view(4, -1)
    assert (again - got).abs().max() <= 1e-6 * got.abs().max()
    assert not torch.equal(again, got)


def _jax_half_loss(jmodel, inputs_j, key_f, eps):
    """One half's ELBO from the JAX pieces at the uniforms of key_f and
    the scale noise eps (test_torch_elbo.py's construction)."""
    def loss(params):
        q = jmodel.posterior.distribution(params["posterior"])
        z_f = q.sample(key_f)
        sd = jmodel.scaler.apply(params["scaler"], inputs_j)
        z_obs = jax_plan_gather(z_f, inputs_j.refl_id, inputs_j.plans.refl)
        ipred = (sd.loc + sd.scale * eps) * jnp.square(z_obs)
        ll = jmodel._masked_ll_sum(
            jmodel.likelihood.build({}, inputs_j), ipred, None)
        return -ll + jnp.sum(q.log_prob(z_f) - jmodel.prior.log_prob(z_f))
    return loss


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_half_step_matches_jax(laue):
    """The parallel form's pass over both halves of a split, from JAX's
    parameters (the posterior moved off the prior), each half's uniforms
    and noise: each half's loss and posterior gradient equal the JAX
    package's ELBO of that half alone; the frozen scaler gets none."""
    port, jax_dm = _managers(laue)
    jmodel, jparams, _ = jax_dm.build_model()
    rng = np.random.default_rng(8)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    for k in ("loc_raw", "scale_raw"):
        jparams["posterior"][k] = jparams["posterior"][k] + 0.1 * \
            rng.normal(size=jparams["posterior"][k].shape).astype(np.float32)
    model, _, _ = port.build_model()
    halves = port.split_data_by_image()
    jhalves = jax_dm.split_data_by_image()
    stacked = stack_halves([port.planned_rows(h).inputs for h in halves],
                           port.n_refl, port.n_images)
    u_f, eps, want = [], [], []
    for k, jh in enumerate(jhalves):
        jh = (jh.sorted_by_harmonic(jax_dm.n_refl) if laue
              else jh.sorted_by_refl())
        inputs_j = jh.with_plans(jax_dm.n_refl, jax_dm.n_images,
                                 mlp_width=jax_dm.mlp_width)
        key_f = jax.random.PRNGKey(20 + k)
        u_f.append(np.asarray(jax.random.uniform(key_f, (port.n_refl,))))
        eps.append(rng.standard_normal(jh.n_obs).astype(np.float32))
        loss, grads = jax.value_and_grad(
            _jax_half_loss(jmodel, inputs_j, key_f, eps[-1]))(
            jax.tree.map(jnp.asarray, jparams))
        want.append((float(loss), grads["posterior"]))
    p = params_from_jax(jparams, "cpu")
    p["posterior"] = {name: v.expand((2,) + v.shape).clone()
                      .requires_grad_(True)
                      for name, v in p["posterior"].items()}
    loss, metrics = halves_elbo(
        model, p, stacked, torch.tensor(np.stack(u_f))[None], [0, 0],
        eps=torch.tensor(np.concatenate(eps))[None])
    names = sorted(p["posterior"])
    grads = torch.autograd.grad(loss.sum(), [p["posterior"][n]
                                             for n in names])
    assert loss.shape == metrics["NLL"].shape == (2,)
    for k, (w_loss, w_grads) in enumerate(want):
        np.testing.assert_allclose(loss[k].item(), w_loss, rtol=1e-5)
        for name, g in zip(names, grads):
            w = np.asarray(w_grads[name])
            err = np.abs(g[k].numpy() - w).max() / np.abs(w).max()
            assert err <= 1e-4, (k, name, err)
    assert not p["scaler"]["mlp"]["out"]["w"].requires_grad


def _serial_and_parallel(port, halves, steps, seeds):
    """Each half trained alone by Trainer.train and all of them by
    train_halves, from the same model with the scaler frozen."""
    model, params, trainer = port.build_model()
    trainer = dataclasses.replace(trainer, freeze=("scaler",))
    serial = [trainer.train(params, seeded_generator(seed, "cpu"),
                            port.planned_inputs(h).inputs, steps,
                            chunk_size=2, device="cpu")
              for h, seed in zip(halves, seeds)]
    stacked = stack_halves([port.planned_rows(h).inputs for h in halves],
                           port.n_refl, port.n_images)
    trained, history = train_halves(trainer, params, seeds, stacked, steps,
                                    chunk_size=2, device="cpu")
    return trainer, serial, trained, history


def _assert_half_equals_serial(trainer, trained, history, k, serial,
                               exact=True):
    """exact: True for bit for bit, else the rtol (False: 1e-5)."""
    p_serial, h_serial = serial
    got = dict(flatten_params(half_params(trained, k, trainer.freeze)))
    for name, want in flatten_params(p_serial):
        if exact is True:
            assert torch.equal(got[name], want), (k, name)
        else:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=exact or 1e-5, atol=1e-6,
                                       err_msg=f"{k} {name}")
    for key, values in h_serial.items():
        np.testing.assert_allclose(np.asarray(history[key])[:, k], values,
                                   rtol=1e-5, err_msg=key)


EV11 = dict(mc_samples=2, refine_uncertainties=True)
# flag sets of the parallel form: (Laue, flags, the two-file double-Wilson
# problem, the parameters bit for bit without clips, else their rtol)
FORMS = {
    "mono": (False, {}, False, True),
    "laue": (True, {}, False, True),
    "analytic_kl": (False, dict(analytic_kl=True), False, True),
    "double_wilson_r": (False, dict(parents="None,0", dwr="0.,0.9",
                                    optimize_double_wilson_r=True), True,
                        True),
    "fused_studentt_ev11": (False, dict(EV11, fused_kernel="on",
                                        studentt_likelihood_dof=4.0), False,
                            True),
    # the Ev11 scalars' gradient sums each half's rows over both samples
    # (the serial form: each sample's rows, then the samples), so their
    # steps, and the posterior's after them, differ in rounding: rtol 1e-4
    # (measured 2.6e-5)
    "ev11": (False, dict(EV11, fused_kernel="off"), False, 1e-4),
    "laue_ev11": (True, EV11, False, True),
}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_parallel_form_equals_serial_form(form, clip):
    """Two repeats (K = 4) of 3 steps: each half's parameters (the
    likelihood's and the prior's too, one set a half) and its loss, NLL,
    KL, rDW and Grad Norm history equal its serial run's. With
    --global-clipnorm 0.5, which clips every step and would couple the
    halves if it took one norm over all of them, the parameters at rtol
    1e-5: each half's norm sums its leaves in a row of K, so the clip
    factor may round otherwise."""
    laue, flags, two_files, exact = FORMS[form]
    flags = dict(flags, global_clipnorm=clip)
    if clip is not None and exact is True:
        exact = False
    if two_files:
        from tests.test_torch_priors import _two_file_managers
        port, _ = _two_file_managers(flags)
    else:
        port, _ = _managers(laue, **flags)
    halves = port.split_data_by_image() + port.split_data_by_image()
    seeds = make_half_keys(3, 2)
    trainer, serial, trained, history = _serial_and_parallel(
        port, halves, 3, seeds)
    assert trained["posterior"]["loc_raw"].shape == (4, port.n_refl)
    assert trainer.model.fused_kernel == (flags.get("fused_kernel") == "on")
    if clip is not None:   # every step clipped
        assert min(min(h["Grad Norm"]) for _, h in serial) > clip
    for k in range(4):
        _assert_half_equals_serial(trainer, trained, history, k, serial[k],
                                   exact)


def test_a_non_finite_half_is_reported_and_spoils_no_other(capsys):
    """Half 0 holds a NaN intensity: its Grad Norm is NaN at every step
    and it is reported; half 1, whose rows follow it in the stacked
    segment sum, trains as it does alone."""
    port, _ = _managers(False)
    halves = list(port.split_data_by_image())
    iobs = halves[0].intensities.clone()
    iobs[5] = float("nan")
    halves[0] = halves[0].replace(intensities=iobs)
    seeds = make_half_keys(3, 1)
    trainer, serial, trained, history = _serial_and_parallel(
        port, halves, 3, seeds)
    assert "half(s) [0]" in capsys.readouterr().out
    norms = np.asarray(history["Grad Norm"])
    assert np.isnan(norms[:, 0]).all() and np.isfinite(norms[:, 1]).all()
    assert np.isfinite(trained["posterior"]["loc_raw"].numpy()).all()
    _assert_half_equals_serial(trainer, trained, history, 1, serial[1])


def _steps_asking_every_leaf(trainer, params, generator, inputs, steps):
    """Trainer.train's step as it was: autograd asked for every leaf,
    the frozen ones then zeroed by transform_grads."""
    params = map_params(lambda t: t.detach().clone().requires_grad_(True),
                        params)
    named = flatten_params(params)
    leaves = [t for _, t in named]
    frozen = [path.split("/")[0] in trainer.freeze for path, _ in named]
    opt = trainer.optimizer(leaves)
    base = int(torch.randint(0, 2 ** 32, (1,), generator=generator).item())
    history = {k: [] for k in trainer.metric_keys}
    for i in range(steps):
        loss, metrics = trainer.model.elbo(params, inputs, generator,
                                           seed=base | (i << 32))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        grads, metrics["Grad Norm"] = trainer.transform_grads(grads, frozen)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        for k in history:
            history[k].append(float(metrics[k].detach()))
    return [t.detach() for t in leaves], history


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_frozen_leaves_take_no_backward(laue, monkeypatch):
    """With the scaler frozen K1's output needs no gradient (so no K1-bwd
    on the card), and 4 steps give the parameters and every history
    column of the old step bit for bit; unfrozen, it needs one."""
    port, _ = _managers(laue)
    _, params, trainer = port.build_model()
    rows = port.planned_inputs().inputs
    needs_grad = []
    head = port_nn.fused_mlp_trunk_head

    def spy(*args, **kwargs):
        out = head(*args, **kwargs)
        needs_grad.append(out[0].requires_grad)
        return out
    monkeypatch.setattr(port_nn, "fused_mlp_trunk_head", spy)
    frozen = dataclasses.replace(trainer, freeze=("scaler",))
    got, history = frozen.train(params, seeded_generator(4, "cpu"), rows, 4,
                                chunk_size=2, device="cpu")
    assert needs_grad == [False] * 4
    leaves, want = _steps_asking_every_leaf(
        frozen, params, seeded_generator(4, "cpu"), rows, 4)
    assert len(needs_grad) == 8
    for (name, a), b in zip(flatten_params(got), leaves):
        assert torch.equal(a, b), name
    assert list(history) == list(want)
    for k in want:
        np.testing.assert_array_equal(history[k], want[k], err_msg=k)
    trainer.train(params, seeded_generator(4, "cpu"), rows, 1,
                  device="cpu")
    assert needs_grad[-1] is True
    for name, t in flatten_params(got["scaler"]):
        assert torch.equal(t, dict(flatten_params(params["scaler"]))[name])
