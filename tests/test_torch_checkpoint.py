"""Training checkpoints and resume (careless_tpu_torch/utils/checkpoint.py
save_state / load_state, Trainer.train's checkpoint_path and resume_from,
the CLI's --checkpoint-every and --resume-from) against careless_tpu, on
the CPU.

A run resumed from its own checkpoint repeats the uninterrupted run bit
for bit (params, Adam state, random state and history), mono and Laue,
with and without held-out rows. Files cross between the packages both
ways: a checkpoint that optax's chain and the JAX save_state wrote loads
into the port for each clip option (params and moments bit for bit, the
step count, and one further step within f32 rounding of optax's: rtol
1e-5, atol 1e-7, test_torch_elbo.py's Adam tolerance); the port's files
load through the JAX load_state into the JAX Trainer's structures; and
each CLI resumes the other's checkpoint to its end. A run stopped by a
non-finite gradient leaves its last healthy checkpoint; a history written
with validation resumes without it and the reverse, rectangular.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.main import main as jax_main
from careless_tpu.models.merging.variational import Trainer as JTrainer
from careless_tpu.utils.checkpoint import load_state as jax_load_state
from careless_tpu.utils.checkpoint import save_state as jax_save_state
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.main import write_history
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import (Trainer,
                                                           flatten_params)
from careless_tpu_torch.utils.checkpoint import (adam_prefix, load_state,
                                                 save_state)
from careless_tpu_torch.utils.params import params_from_jax, params_to_numpy
from tests.test_torch_elbo import OPTIONS

torch.set_num_threads(2)

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,XDET"
FLAGS = ["--mlp-layers=2", "--disable-progress-bar"]


def _manager(laue, seed=0, n=2400, n_refl=300, n_images=12, d=4):
    arrays, asu, _ = chip_smoke.build_problem(seed, n, n_refl, n_images, d,
                                              laue=laue)
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed})
    return DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                       parser, device="cpu")


def _flat(params):
    return {k: v.detach().numpy() for k, v in flatten_params(params)}


def _assert_same_params(a, b):
    a, b = _flat(a), _flat(b)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_files(a, b):
    a, b = dict(np.load(a)), dict(np.load(b))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("validation", [False, True])
@pytest.mark.parametrize("laue", [False, True])
def test_resume_repeats_the_uninterrupted_run(tmp_path, laue, validation):
    """A: 12 steps; B: 8 steps, checkpointed; C: B's checkpoint resumed to
    12 with another generator (the file's state replaces it). C's params,
    history and final checkpoint (Adam moments and count, generator, base
    key) equal A's bit for bit."""
    dm = _manager(laue)
    train, test = (dm.split_data_by_refl(0.2) if validation
                   else (dm.inputs, None))
    _, params, trainer = dm.build_model()
    rows = dm.planned_inputs(train).inputs
    held = None if test is None else dm.planned_inputs(test).inputs
    runs = {}
    for name, steps, seed, resume in (("A", 12, 0, None), ("B", 8, 0, None),
                                      ("C", 12, 7, "B")):
        runs[name] = trainer.train(
            params, seeded_generator(seed, "cpu"), rows, steps, chunk_size=4,
            device="cpu", validation_data=held, validation_frequency=4,
            checkpoint_path=str(tmp_path / name), checkpoint_frequency=steps,
            resume_from=None if resume is None else str(tmp_path / resume))
    (pa, ha), (pb, hb), (pc, hc) = runs["A"], runs["B"], runs["C"]
    _assert_same_params(pa, pc)
    assert list(ha) == list(hc) == list(trainer.metric_keys) + (
        ["NLL_val"] if validation else [])
    for k in ha:
        assert len(ha[k]) == 12
        np.testing.assert_array_equal(ha[k], hc[k], err_msg=k)
        np.testing.assert_array_equal(ha[k][:8], hb[k], err_msg=k)
    _assert_same_files(tmp_path / "A.npz", tmp_path / "C.npz")
    assert not np.array_equal(_flat(pa)["posterior/loc_raw"],
                              _flat(pb)["posterior/loc_raw"])


def _optax_state(opts, n_steps=3, seed=2):
    """(params, optax state after n_steps updates, the next gradient) of
    test_adam_steps_match_optax's problem."""
    rng = np.random.default_rng(seed)
    params = {"posterior": {"loc_raw": rng.normal(size=6),
                            "scale_raw": rng.normal(size=6)},
              "scaler": {"w": rng.normal(size=(3, 3)),
                         "b": rng.normal(size=3)}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    opt = JTrainer(None, **opts).optimizer()
    state = opt.init(params)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape), jnp.float32), params)
        for _ in range(n_steps + 1)]
    for g in grads[:-1]:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return opt, params, state, grads[-1]


def _port_trainer(opts, like):
    """A port Trainer with `opts`, a zeroed tree of `like`'s layout and
    its (unstepped) optimizer."""
    p = params_from_jax(jax.tree.map(lambda a: np.zeros_like(a), like),
                        "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_params(p)]
    trainer = Trainer(None, **opts)
    return trainer, p, leaves, trainer.optimizer(leaves)


@pytest.mark.parametrize("opts", OPTIONS)
def test_jax_checkpoint_loads_into_the_port(tmp_path, opts):
    """The JAX save_state's file after three optax updates: the port reads
    the params and moments bit for bit from the key path the JAX file
    holds (adam_prefix), its step is the count, and one more step from the
    loaded state with a fixed gradient matches optax's."""
    opt, pj, state, g = _optax_state(opts)
    path = str(tmp_path / "jax")
    jax_save_state(path, pj, state, 3, {"loss": [3.0, 2.0, 1.0]})
    opt_keys = sorted(k for k in np.load(path + ".npz").files
                      if k.startswith("opt/"))
    prefix = adam_prefix(**opts)
    assert opt_keys == [prefix + s for s in (".count", ".mu", ".nu")]

    trainer, p, leaves, topt = _port_trainer(opts, pj)
    step, history, rng = load_state(path, p, topt, prefix)
    assert step == 3 and history == {"loss": [3.0, 2.0, 1.0]} and rng is None
    _assert_same_params(p, params_from_jax(
        jax.tree.map(np.asarray, pj), "cpu"))
    stored = np.load(path + ".npz")
    mu = np.concatenate([topt.state[t]["exp_avg"].reshape(-1).numpy()
                         for t in leaves])
    nu = np.concatenate([topt.state[t]["exp_avg_sq"].reshape(-1).numpy()
                         for t in leaves])
    np.testing.assert_array_equal(mu, stored[prefix + ".mu"])
    np.testing.assert_array_equal(nu, stored[prefix + ".nu"])
    for t in leaves:
        s = topt.state[t]["step"]
        assert s.dtype == torch.float32 and s.device.type == "cpu"
        assert s.item() == int(stored[prefix + ".count"]) == 3

    updates, _ = opt.update(g, state, pj)
    want = optax.apply_updates(pj, updates)
    grads, _ = trainer.transform_grads(
        [torch.tensor(np.asarray(x)) for x in jax.tree.leaves(g)],
        [False] * len(leaves))
    for leaf, gl in zip(leaves, grads):
        leaf.grad = gl
    topt.step()
    for a, b in zip(jax.tree.leaves(params_to_numpy(p)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("opts", OPTIONS)
def test_port_checkpoint_loads_into_jax(tmp_path, opts):
    """The port's file after three steps loads through the JAX load_state
    into the JAX Trainer's structures (optax's state for `opts`): params
    and moments bit for bit, the count, and the JAX package's own file of
    the same state holds the same keys (the port's rng/ entries aside)."""
    opt, pj, state, _ = _optax_state(opts)
    trainer, p, leaves, topt = _port_trainer(opts, pj)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads, _ = trainer.transform_grads(
            [torch.tensor(rng.normal(size=t.shape).astype(np.float32))
             for t in leaves], [False] * len(leaves))
        for leaf, gl in zip(leaves, grads):
            leaf.grad = gl
        topt.step()
    path = str(tmp_path / "port")
    save_state(path, p, topt, adam_prefix(**opts), 3, {"loss": [1.0] * 3})
    params, got, step, history = jax_load_state(path, pj, state)
    assert step == 3 and history == {"loss": [1.0] * 3}
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            params_to_numpy(p))):
        np.testing.assert_array_equal(np.asarray(a), b)
    (adam,) = [s for s in jax.tree.leaves(
        got, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert int(adam.count) == 3 and adam.count.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(adam.mu), np.concatenate(
        [topt.state[t]["exp_avg"].reshape(-1).numpy() for t in leaves]))
    np.testing.assert_array_equal(np.asarray(adam.nu), np.concatenate(
        [topt.state[t]["exp_avg_sq"].reshape(-1).numpy() for t in leaves]))
    jax_save_state(str(tmp_path / "jax"), params, got, 3, history)
    ours = {k for k in np.load(path + ".npz").files
            if not k.startswith("rng/")}
    assert ours == set(np.load(str(tmp_path / "jax.npz")).files)


class _Poisoned:
    """A model whose loss turns NaN from step `bad` on."""

    def __init__(self, model, bad):
        self.model, self.bad = model, bad

    @property
    def metric_names(self):
        return self.model.metric_names

    def elbo(self, params, inputs, generator, seed=0, shard=None):
        loss, metrics = self.model.elbo(params, inputs, generator, seed=seed,
                                        shard=shard)
        if seed >> 32 >= self.bad:
            loss = loss * float("nan")
            metrics = {**metrics, "loss": loss}
        return loss, metrics


def test_aborted_run_keeps_the_last_healthy_checkpoint(tmp_path, capsys):
    """Checkpoints every 4 steps; step 9's gradient is NaN, so the run
    stops in its third chunk with 10 steps of history, and the file is
    still the one written at step 8: equal to an 8-step healthy run's."""
    dm = _manager(False)
    model, params, trainer = dm.build_model()
    rows = dm.planned_inputs().inputs
    poisoned = dataclasses.replace(trainer, model=_Poisoned(model, 9))
    _, history = poisoned.train(
        params, seeded_generator(0, "cpu"), rows, 12, chunk_size=4,
        device="cpu", checkpoint_path=str(tmp_path / "bad"),
        checkpoint_frequency=4)
    assert "numerical issues" in capsys.readouterr().out
    assert all(len(v) == 10 for v in history.values())
    assert np.isnan(history["Grad Norm"][9])
    trainer.train(params, seeded_generator(0, "cpu"), rows, 8, chunk_size=4,
                  device="cpu", checkpoint_path=str(tmp_path / "good"),
                  checkpoint_frequency=8)
    assert int(np.load(tmp_path / "bad.npz")["__step__"]) == 8
    _assert_same_files(tmp_path / "bad.npz", tmp_path / "good.npz")
    assert not (tmp_path / "bad.npz.tmp.npz").exists()


@pytest.mark.parametrize("first", ["with", "without"])
def test_history_resumes_across_metric_sets(tmp_path, first):
    """A checkpoint written with held-out rows resumes without them (its
    NLL_val is dropped) and the reverse (NLL_val NaN over the resumed
    steps); every column has a row per step, and the CSV writes."""
    dm = _manager(False)
    train, test = dm.split_data_by_refl(0.2)
    _, params, trainer = dm.build_model()
    rows = dm.planned_inputs(train).inputs
    held = dm.planned_inputs(test).inputs
    sets = [held, None] if first == "with" else [None, held]
    trainer.train(params, seeded_generator(0, "cpu"), rows, 6, chunk_size=3,
                  device="cpu", validation_data=sets[0],
                  validation_frequency=3,
                  checkpoint_path=str(tmp_path / "ck"),
                  checkpoint_frequency=6)
    _, history = trainer.train(
        params, seeded_generator(0, "cpu"), rows, 9, chunk_size=3,
        device="cpu", validation_data=sets[1], validation_frequency=3,
        resume_from=str(tmp_path / "ck"))
    assert {len(v) for v in history.values()} == {9}
    if first == "with":
        assert "NLL_val" not in history
    else:
        val = np.asarray(history["NLL_val"])
        assert np.isnan(val[:6]).all() and np.isfinite(val[6:]).all()
    write_history(history, str(tmp_path / "h.csv"))
    assert len(pd.read_csv(tmp_path / "h.csv")) == 9


def test_resume_refuses_another_devices_generator(tmp_path):
    dm = _manager(False)
    _, params, trainer = dm.build_model()
    rows = dm.planned_inputs().inputs
    trainer.train(params, seeded_generator(0, "cpu"), rows, 2, device="cpu",
                  checkpoint_path=str(tmp_path / "ck"),
                  checkpoint_frequency=2)
    stored = dict(np.load(tmp_path / "ck.npz"))
    stored["rng/device_type"] = np.asarray("cuda")
    np.savez(tmp_path / "cuda.npz", **stored)
    with pytest.raises(ValueError, match="cuda generator.*on cpu"):
        trainer.train(params, seeded_generator(0, "cpu"), rows, 4,
                      device="cpu", resume_from=str(tmp_path / "cuda"))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_state_errors_as_jax(tmp_path, fault):
    _, pj, state, _ = _optax_state({})
    path = str(tmp_path / "ck.npz")
    jax_save_state(path, pj, state, 3, {})
    stored = dict(np.load(path))
    key = "params/scaler/w"
    if fault == "missing":
        del stored[key]
    else:
        stored[key] = np.zeros((3, 4), np.float32)
    np.savez(path, **stored)
    _, p, _, topt = _port_trainer({}, pj)
    kind = KeyError if fault == "missing" else ValueError
    with pytest.raises(kind) as got:
        load_state(path, p, topt, adam_prefix())
    with pytest.raises(kind) as want:
        jax_load_state(path, pj, state)
    assert str(got.value) == str(want.value)
    assert key in str(got.value)


@pytest.fixture(scope="module")
def cli_checkpoints(tmp_path_factory):
    """A seeded mono MTZ; each CLI's 3-step run checkpointed at step 3, and
    each resumed to step 5 from the other package's checkpoint."""
    d = tmp_path_factory.mktemp("ckcli")
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(5, 3000, 30, CELL,
                                                    "P 63", 3.0)
    mtz = str(d / "in.mtz")
    jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                            spacegroup=jx.SpaceGroup.from_name("P 63"),
                            mtz_dtypes=types_), mtz)
    out = {k: str(d / k) for k in ("jax", "port", "jax_from_port",
                                   "port_from_jax")}
    first = ["--iterations=3", "--checkpoint-every=3", *FLAGS]
    jax_main(["mono", KEYS, mtz, out["jax"], *first])
    port_main(["mono", KEYS, mtz, out["port"], *first, "--disable-gpu"])
    jax_main(["mono", KEYS, mtz, out["jax_from_port"], "--iterations=5",
              f"--resume-from={out['port']}_checkpoint", *FLAGS])
    port_main(["mono", KEYS, mtz, out["port_from_jax"], "--iterations=5",
               f"--resume-from={out['jax']}_checkpoint", *FLAGS,
               "--disable-gpu"])
    return out


@pytest.mark.parametrize("direction", ["jax_from_port", "port_from_jax"])
def test_each_cli_resumes_the_others_checkpoint(cli_checkpoints, direction):
    """Five steps of history, the first three the checkpointed run's; the
    checkpoint files name the same keys (the port's rng/ entries aside)."""
    source = cli_checkpoints[direction.split("_from_")[1]]
    resumed = pd.read_csv(cli_checkpoints[direction] + "_history.csv")
    written = pd.read_csv(source + "_history.csv")
    assert list(resumed.columns) == list(written.columns)
    assert len(resumed) == 5 and np.isfinite(resumed.to_numpy()).all()
    np.testing.assert_array_equal(resumed.to_numpy()[:3],
                                  written.to_numpy())
    keys = {p: {k for k in np.load(cli_checkpoints[p]
                                   + "_checkpoint.npz").files
                if not k.startswith("rng/")} for p in ("jax", "port")}
    assert keys["jax"] == keys["port"]


def test_prior_r_raw_crosses_both_ways(tmp_path):
    """--optimize-double-wilson-r puts the prior's r in the parameters
    (params/prior/r_raw): a checkpoint of the port's two-file run loads
    through the JAX load_state into the JAX model's tree and optax state
    (r_raw, its Adam moments and the count bit for bit), and the JAX
    package's checkpoint of its own run loads into the port's."""
    from tests.test_torch_priors import _two_file_managers

    flags = dict(parents="None,0", dwr="0.,0.9",
                 optimize_double_wilson_r=True)
    port, jdm = _two_file_managers(flags)
    _, params, trainer = port.build_model()
    trainer.train(params, seeded_generator(0, "cpu"),
                  port.planned_inputs().inputs, 2, device="cpu",
                  checkpoint_path=str(tmp_path / "port"),
                  checkpoint_frequency=2)
    stored = np.load(tmp_path / "port.npz")
    assert stored["params/prior/r_raw"].shape == (2,)
    jmodel, jparams, jtrainer = jdm.build_model()
    state = jtrainer.optimizer().init(jparams)
    got, got_state, step, _ = jax_load_state(str(tmp_path / "port"),
                                             jparams, state)
    assert step == 2
    np.testing.assert_array_equal(np.asarray(got["prior"]["r_raw"]),
                                  stored["params/prior/r_raw"])
    (adam,) = [s for s in jax.tree.leaves(
        got_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert int(adam.count) == 2
    np.testing.assert_array_equal(np.asarray(adam.mu),
                                  stored[adam_prefix() + ".mu"])

    jtrainer.train(jparams, jax.random.PRNGKey(0),
                   jdm.inputs.sorted_by_refl().with_plans(
                       jdm.n_refl, jdm.n_images, mlp_width=jdm.mlp_width),
                   2, progress=False, checkpoint_path=str(tmp_path / "jax"),
                   checkpoint_frequency=2)
    written = np.load(tmp_path / "jax.npz")
    assert not np.array_equal(written["params/prior/r_raw"],
                              np.asarray(jparams["prior"]["r_raw"]))
    _, params, trainer = port.build_model()
    leaves = [t for _, t in flatten_params(params)]
    opt = trainer.optimizer(leaves)
    step, _, rng = load_state(str(tmp_path / "jax"), params, opt,
                              adam_prefix())
    assert step == 2 and rng is None
    np.testing.assert_array_equal(params["prior"]["r_raw"].numpy(),
                                  written["params/prior/r_raw"])
    at = [k for k, _ in flatten_params(params)].index("prior/r_raw")
    np.testing.assert_array_equal(
        opt.state[leaves[at]]["exp_avg"].numpy(),
        np.split(written[adam_prefix() + ".mu"], np.cumsum(
            [t.numel() for t in leaves])[:-1])[at])
