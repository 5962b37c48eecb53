"""Multi-device training of the port (parallel/shard.py,
parallel/distributed.py, the shard-aware ELBO and Trainer) against
careless_tpu's observation and Monte Carlo sharding, on the CPU.

- The shards: each port shard's rows are the rows of the same JAX shard of
  careless_tpu.parallel.shard.prepare_sharded_layout that are not padding,
  in the same order for mono and as the same set for Laue (cut at chain
  boundaries), for W = 2 and 8; host_observation_slice is the JAX
  function's; the device-count and mc-divisibility refusals carry the JAX
  package's messages.
- The noise: a shard's Philox normals are the matching slice of the
  unsharded draw, bit for bit.
- The ELBO: the per-shard losses and gradients, added up in one process,
  equal JAX elbo_sharded / elbo_mc_sharded on the 8-device CPU mesh
  (tests/conftest.py) at the same draws: the loss at rtol 1e-5 and each
  gradient within 1e-4 of its tensor's largest entry (tests/
  test_torch_elbo.py's tolerance: f32 sums over rows in another order).
  The port is fed JAX's own draws, rebuilt from its key as elbo_sharded
  makes them (split, the posterior's uniforms, normal(k_s, (S, n)) on the
  padded layout), each port shard the noise of its rows that are not
  padding. The JAX package masks the never-hit Laue group rows out of its
  sharded loss; the port keeps them, as its unsharded loss does, so the
  Laue loss is compared with their constant log-likelihood taken off.
- Training: two gloo ranks, spawned once (chip_smoke.shard_rank), train the
  observation, Monte Carlo and Laue runs 5 steps each; against the same
  runs in this process (chip_smoke.shard_reference) within
  tests/parallel/test_distributed.py's tolerances (metrics rtol 2e-4 /
  atol 1e-4, parameters rtol 5e-4 / atol 1e-5), the ranks' parameters and
  histories bit for bit equal; at world size 1 (a gloo group in this
  process) bit for bit the unsharded run; and train_halves spread over two
  ranks bit for bit train_halves in one process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import careless_tpu.parallel.distributed as jdist
import careless_tpu.parallel.shard as jshard
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.models.likelihoods import laue as jlaue
from careless_tpu.models.likelihoods import mono as jmono
from careless_tpu.models.merging.variational import \
    VariationalMergingModel as JModel
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.likelihoods import laue as tlaue
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.ops.fused_elbo import prng_normal
from careless_tpu_torch.ops.plan_gather import ChainGatherPlan
from careless_tpu_torch.parallel import distributed
from careless_tpu_torch.parallel import shard as tshard
from careless_tpu_torch.parallel.xval import (halves_of_rank, stack_halves,
                                              train_halves)
from careless_tpu_torch.utils.params import params_from_jax
from tests.test_torch_elbo import _jax_parts, _torch_model

torch.set_num_threads(2)

N_REFL, N_IMAGES, D = 150, 12, 5
N_LAYERS = 3


def _indexed(arrays):
    """arrays with metadata column 0 set to 1 + each row's index (0 marks
    JAX padding rows)."""
    meta = np.array(arrays[3], np.float32)
    meta[:, 0] = 1 + np.arange(len(meta))
    return arrays[:3] + (meta,) + arrays[4:]


def _port_layout(arrays):
    """The single-device layout of the port (DataManager.planned_rows')."""
    inputs = Inputs.from_arrays(*arrays, device="cpu")
    return tshard.prepare_sharded_layout(inputs, 1, N_REFL)[0]


@pytest.mark.parametrize("laue", [False, True])
@pytest.mark.parametrize("world", [2, 8])
def test_shards_are_the_jax_shards_without_padding(laue, world):
    arrays, _, _ = cs.build_problem(world, 3000, N_REFL, N_IMAGES, D,
                                    laue=laue)
    arrays = _indexed(arrays)
    layout, ranges = tshard.prepare_sharded_layout(
        Inputs.from_arrays(*arrays, device="cpu"), world, N_REFL)
    jl = jshard.prepare_sharded_layout(JInputs.from_arrays(*arrays), world,
                                       n_refl=N_REFL if laue else None)
    rows = np.asarray(jl.metadata)[:, 0].reshape(world, -1)
    assert [lo for lo, _ in ranges] == sorted(lo for lo, _ in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == 3000
    for r, (lo, hi) in enumerate(ranges):
        inputs, shard = tshard.shard_inputs(layout, r, world, N_REFL,
                                            N_IMAGES)
        assert (shard.row_offset, shard.n_total, shard.rank) == (lo, 3000, r)
        got = inputs.metadata[:, 0].numpy()
        want = rows[r][rows[r] != 0]
        if laue:
            assert sorted(got) == sorted(want)
            # whole groups and whole chains, groups numbered from 0
            hid = inputs.harmonic_id.numpy()
            assert hid[0] == 0 and np.all(np.diff(hid) >= 0)
            assert hid[-1] + 1 == len(np.unique(hid))
        else:
            np.testing.assert_array_equal(got, want)


def test_laue_shards_keep_groups_chains_and_the_tail():
    """Each Laue shard's packed group values are its groups' values in the
    whole layout, its tail rows the next share of the whole tail, and the
    shards' chain plans window (no chain straddles a cut)."""
    arrays, _, _ = cs.build_problem(5, 3000, N_REFL, N_IMAGES, D, laue=True)
    layout = _port_layout(arrays)
    hid = layout.harmonic_id.numpy()
    n_groups = hid[-1] + 1
    iobs = layout.intensities.numpy()
    tails = []
    for r in range(3):
        inputs, shard = tshard.shard_inputs(layout, r, 3, N_REFL, N_IMAGES)
        lo, n = shard.row_offset, inputs.n_obs
        g_lo, g_n = hid[lo], inputs.harmonic_id[-1].item() + 1
        np.testing.assert_array_equal(inputs.intensities[:g_n].numpy(),
                                      iobs[g_lo:g_lo + g_n])
        tails.append(inputs.intensities[g_n:].numpy())
        assert inputs.plans.harmonic_run is not None
        assert isinstance(inputs.plans.refl, ChainGatherPlan)
    np.testing.assert_array_equal(np.concatenate(tails), iobs[n_groups:])


def test_host_observation_slice_is_the_jax_function():
    for n in (0, 1, 7, 100, 203, 1000, 4099):
        for world in (1, 2, 3, 4, 7, 8, 16):
            for r in range(world):
                assert distributed.host_observation_slice(n, r, world) == \
                    jdist.host_observation_slice(n, r, world)
    assert distributed.host_observation_slice(10) == slice(0, 10)


def test_device_count_refusal_is_the_jax_message():
    with pytest.raises(ValueError) as jax_err:
        jshard.make_mesh(9)
    with pytest.raises(ValueError) as port_err:
        tshard.check_devices(9, 8)
    assert str(port_err.value) == str(jax_err.value)
    tshard.check_devices(8, 8)


def test_mc_refusal_is_the_jax_message():
    model, params, _, inputs = __import__(
        "__graft_entry__")._tiny_problem(n_obs=64, laue=False)
    model = model.__class__(**{**model.__dict__, "mc_samples": 3})
    with pytest.raises(ValueError) as jax_err:
        model.elbo_mc_sharded(params, jax.random.PRNGKey(0), inputs,
                              jshard.make_mesh(4, axis_name="mc"))
    with pytest.raises(ValueError) as port_err:
        tshard.sample_range(3, 0, 4)
    assert str(port_err.value) == str(jax_err.value)
    assert [tshard.sample_range(4, r, 2) for r in range(2)] == [(0, 2),
                                                                (2, 4)]


@pytest.mark.parametrize("samples,row0,n,n_all", [
    (range(0, 1), 0, 997, 997), (range(0, 3), 0, 997, 997),
    (range(0, 1), 501, 333, 1001), (range(1, 3), 37, 101, 1001),
    (range(2, 4), 0, 1001, 1001)])
def test_shard_noise_is_the_unsharded_slice(samples, row0, n, n_all):
    """The ELBO's scale noise of a shard (rows row0 .. row0 + n of n_all,
    these samples) is the unsharded (S, n_all) draw's slice, bit for bit,
    at offsets that are mostly not multiples of 4."""
    seed = 0x0123456789ABCDEF
    full = prng_normal(4 * n_all, seed, 0, "cpu").view(4, n_all)
    got = _torch_model(np.zeros(3, bool), 1, 2, 3)._scale_noise(
        seed, samples, row0, n, n_all, "cpu")
    assert torch.equal(got, full[samples.start:samples.stop, row0:row0 + n])


# ---------------------------------------------------------------------------
# the per-shard ELBO against elbo_sharded / elbo_mc_sharded
# ---------------------------------------------------------------------------
CASES = {
    # label: (laue, axis, world, mc, fused)
    "mono": (False, "obs", 4, 1, False),
    "laue": (True, "obs", 2, 1, False),
    "fused": (False, "obs", 2, 2, True),
    "mc": (False, "mc", 2, 4, False),
    "mc_fused": (False, "mc", 2, 2, True),
}


def _case(label):
    laue, axis, world, mc, fused = CASES[label]
    n = 1500 if laue else 1000
    arrays, asu, _ = cs.build_problem(11, n, N_REFL, N_IMAGES, D, laue=laue)
    centric = asu.centric
    prior, posterior, scaler = _jax_parts(centric, N_LAYERS, D, N_IMAGES,
                                          fused=False)
    j_lik = jlaue.NormalLikelihood() if laue else jmono.NormalLikelihood()
    jmodel = JModel(posterior, prior, j_lik, scaler, mc_samples=mc,
                    fused_kernel=fused)
    inputs_j = JInputs.from_arrays(*arrays)
    params = {"posterior": posterior.init(np.asarray(prior.mean()),
                                          np.asarray(prior.stddev())),
              "scaler": scaler.init(jax.random.PRNGKey(0), D)}
    rng = np.random.default_rng(12)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    tmodel = dataclasses.replace(
        _torch_model(centric, N_LAYERS, D, N_IMAGES), mc_samples=mc,
        fused_kernel=fused,
        **({"likelihood": tlaue.NormalLikelihood()} if laue else {}))
    return (laue, axis, world, mc, jmodel, params, inputs_j, tmodel,
            arrays)


@pytest.mark.parametrize("label", list(CASES))
def test_shard_elbo_sums_match_jax(label):
    laue, axis, world, mc, jmodel, params, inputs_j, tmodel, arrays = \
        _case(label)
    key = jax.random.PRNGKey(3)
    k_f, k_s = jax.random.split(key)
    u_f = torch.tensor(np.asarray(
        jax.random.uniform(k_f, (mc, N_REFL), jnp.float32)))
    if axis == "obs":
        sharded, mesh = jshard.shard_inputs_over_mesh(
            inputs_j, world, n_refl=N_REFL, n_images=N_IMAGES)

        def jax_loss(p):
            return jmodel.elbo_sharded(p, key, sharded, mesh)
        n_jax = sharded.n_obs
    else:
        planned_j = inputs_j.sorted_by_refl().with_plans(N_REFL, N_IMAGES)
        mesh = jshard.make_mesh(world, axis_name="mc")

        def jax_loss(p):
            return jmodel.elbo_mc_sharded(p, key, planned_j, mesh)
        n_jax = inputs_j.n_obs
    (loss_j, m_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    eps = torch.tensor(np.asarray(
        jax.random.normal(k_s, (mc, n_jax), jnp.float32)))

    layout = _port_layout(arrays)
    p = params_from_jax(params, "cpu")
    named = flatten_params(p)
    leaves = [t.requires_grad_(True) for _, t in named]
    width = n_jax // world
    loss, grads, ll = 0.0, None, 0.0
    for r in range(world):
        if axis == "obs":
            inputs, shard = tshard.shard_inputs(layout, r, world, N_REFL,
                                                N_IMAGES)
            e = eps[:, r * width:r * width + inputs.n_obs]
        else:
            inputs = layout.with_plans(N_REFL, N_IMAGES)
            shard = tshard.sample_shard(mc, r, world, inputs.n_obs)
            e = eps[shard.samples[0]:shard.samples[1]]
        assert tmodel._fused_eligible(inputs) == CASES[label][4]
        loss_r, m_r = tmodel.elbo(p, inputs, u_f=u_f, eps=e, shard=shard)
        g = torch.autograd.grad(loss_r, leaves, allow_unused=True)
        g = [torch.zeros_like(t) if x is None else x
             for x, t in zip(g, leaves)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss, ll = loss + loss_r.item(), ll + m_r["ll"]
    tail = 0.0
    if laue:
        planned = layout.with_plans(N_REFL, N_IMAGES)
        lik = tmodel.likelihood.build({}, planned)
        run = planned.plans.harmonic_run
        tail = (lik.distribution.log_prob(torch.zeros(planned.n_obs))
                * run.tail_mask).sum().item()
    metrics = tmodel.sharded_metrics(m_r, ll, layout.n_obs)
    np.testing.assert_allclose(metrics["NLL"].item() + tail,
                               float(m_j["NLL"]), rtol=1e-5)
    np.testing.assert_allclose(loss + tail, float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss"].item() + tail, float(loss_j),
                               rtol=1e-5)
    want = jax.tree.leaves(grads_j)
    assert len(want) == len(grads)
    for (path, _), g, w in zip(named, grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), path


# ---------------------------------------------------------------------------
# training over two gloo ranks
# ---------------------------------------------------------------------------
CFG = cs.shard_config(0, card=False, mono=(3000, 200, 20, D, N_LAYERS),
                      laue=(4000, 300, 20, D, N_LAYERS), steps=5, chunk=5,
                      mc_flags=dict(mc_samples=2, fused_kernel="on"),
                      laue_cap=8)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    ranks = distributed.spawn(cs.shard_rank, 2, (CFG,), "gloo", threads=1,
                              store_dir=str(store))
    return ranks, cs.shard_reference(torch, torch.device("cpu"), CFG)


@pytest.mark.parametrize("run", [0, 1, 2], ids=["obs", "mc", "laue"])
def test_two_ranks_train_as_one_process(two_ranks, run):
    ranks, refs = two_ranks
    a, b, ref = ranks[0][run], ranks[1][run], refs[run]
    label, _, _, laue, axis = cs.shard_runs(CFG)[run]
    assert a["label"] == ref["label"] == label
    if axis == "mc":
        assert a["samples"] == (0, 1) and b["samples"] == (1, 2)
        assert a["n_local"] == b["n_local"] == ref["n_local"]
        assert a["fused_kernel"]
    else:
        assert a["row_offset"] == 0 and b["row_offset"] == a["n_local"]
        assert a["n_local"] + b["n_local"] == ref["n_local"]
    # the ranks agree bit for bit
    assert a["history"] == b["history"] and a["loss0"] == b["loss0"]
    for x, y in zip(a["params"], b["params"]):
        assert np.array_equal(x, y)
    # and train as the one process does
    np.testing.assert_allclose(a["loss0"], ref["loss0"], rtol=1e-5)
    for g, w in zip(a["grads0"], ref["grads0"]):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    assert list(a["history"]) == list(ref["history"])
    for k in ref["history"]:
        np.testing.assert_allclose(a["history"][k], ref["history"][k],
                                   rtol=2e-4, atol=1e-4, err_msg=k)
    for x, w in zip(a["params"], ref["params"]):
        np.testing.assert_allclose(x, w, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("run", [0, 2], ids=["obs", "laue"])
def test_world_size_one_is_the_unsharded_run(two_ranks, tmp_path, run):
    ref = two_ranks[1][run]
    distributed.initialize("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        one = cs.shard_run(torch, torch.device("cpu"), CFG,
                           cs.shard_runs(CFG)[run], 0, 1)
    finally:
        torch.distributed.destroy_process_group()
    assert one["history"] == ref["history"]
    assert one["loss0"] == ref["loss0"]
    for g, w in zip(one["grads0"], ref["grads0"]):
        assert torch.equal(g, w)
    for x, w in zip(one["params"], ref["params"]):
        assert np.array_equal(x, w)


def test_process_group_that_fails_to_form_raises(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize("gloo")
    assert not distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0


# ---------------------------------------------------------------------------
# the crossvalidation halves over two ranks
# ---------------------------------------------------------------------------
HALVES = (2000, 150, 16, D, 2)


def test_halves_spread_over_two_ranks_are_the_one_process_halves(tmp_path):
    steps = 3
    ranks = distributed.spawn(cs.halves_rank, 2, (4, HALVES, steps), "gloo",
                              threads=1, store_dir=str(tmp_path))
    trainer, params, seeds, rows, n_refl, n_images = cs.halves_case(
        "cpu", 4, *HALVES)
    trained, history = train_halves(trainer, params, seeds,
                                    stack_halves(rows, n_refl, n_images),
                                    steps, chunk_size=steps, device="cpu")
    want = [t.numpy() for _, t in flatten_params(trained)]
    for got, got_history in ranks:
        assert len(got) == len(want)
        for x, w in zip(got, want):
            assert x.shape == w.shape and np.array_equal(x, w)
        assert got_history == history


@pytest.mark.parametrize("k,world,want", [
    (4, 2, [range(0, 2), range(2, 4)]), (4, 4, [range(r, r + 1)
                                                for r in range(4)]),
    (4, 3, [range(4), range(0), range(0)]), (2, 4, [range(2)] + [range(0)]
                                              * 3)])
def test_halves_of_rank(monkeypatch, k, world, want):
    """Each rank's halves: K / W each, or all on rank 0 when W does not
    divide K, as the JAX package then shards nothing."""
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    got = []
    for r in range(world):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        got.append(halves_of_rank(k))
    assert got == want
