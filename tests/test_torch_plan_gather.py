"""The port's planned gather (K2 forward, planned segment-sum backward)
against careless_tpu.ops.plan_gather, np.bincount and a flat cumsum; K5's
plain version against the JAX package's windowed_gather_stream (interpret
mode), and the chain gather plan and plan_convolve of the Laue path.

Forward values are exact copies, so they must match bit for bit. Table
gradients are sums of the cotangent over each id's rows; the JAX package
and the port add them in different orders (one-hot histogram or windowed
kernel there, two-level cumsum here), so they agree to f32 rounding of
the chunk magnitude: atol 1e-5 on O(1) cotangents.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import careless_tpu.ops.plan_gather as jpg
import careless_tpu_torch.ops.plan_gather as tpg
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.ops.plan_gather import make_gather_plan as jax_plan
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu.ops.table_gather import \
    windowed_gather_stream as jax_windowed_gather_stream
from careless_tpu_torch.ops.plan_gather import (_CHUNK, _plan_windows,
                                                make_gather_plan,
                                                plan_gather,
                                                segment_sum_by_plan)
from careless_tpu_torch.ops.table_gather import (plain_gather, table_gather,
                                                 windowed_gather_stream)

torch.set_num_threads(2)


def _ids(rng, n, t, sort, sparse):
    # sparse: only even ids occur, so every odd id has an empty segment
    pool = np.arange(0, t, 2) if sparse else np.arange(t)
    ids = rng.choice(pool, n)
    return (np.sort(ids) if sort else ids).astype(np.int32)


@pytest.mark.parametrize("n,t,sort,sparse", [
    (3000, 400, True, False),    # z_f-like: sorted refl ids
    (3000, 400, True, True),     # with absent ids
    (2500, 37, False, False),    # image-like: unsorted, permuted backward
    (2500, 37, False, True),
    (9000, 5000, False, True),   # mostly empty segments, more than a chunk
])
def test_plan_gather_matches_jax(n, t, sort, sparse):
    rng = np.random.default_rng(n + t)
    ids = _ids(rng, n, t, sort, sparse)
    table = rng.normal(size=t).astype(np.float32)
    ct = rng.normal(size=n).astype(np.float32)

    plan_j = jax_plan(ids, t)
    out_j, vjp = jax.vjp(
        lambda tab: jax_plan_gather(tab, jnp.asarray(ids), plan_j),
        jnp.asarray(table))
    (g_j,) = vjp(jnp.asarray(ct))

    ids_t = torch.tensor(ids)
    plan = make_gather_plan(ids_t, t)
    assert (plan.perm is None) == sort
    tab = torch.tensor(table, requires_grad=True)
    out = plan_gather(tab, ids_t, plan)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    (g,) = torch.autograd.grad(out, tab, torch.tensor(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5)
    if sparse:
        assert np.all(g.numpy()[1::2] == 0.0)


@pytest.mark.parametrize("sort", [True, False])
def test_segment_sum_matches_bincount(sort):
    rng = np.random.default_rng(5)
    n, t = 20_000, 3_000
    ids = _ids(rng, n, t, sort, sparse=False)
    contrib = rng.normal(size=n).astype(np.float32)
    plan = make_gather_plan(torch.tensor(ids), t)
    got = segment_sum_by_plan(torch.tensor(contrib), plan).numpy()
    want = np.bincount(ids, weights=contrib.astype(np.float64), minlength=t)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_short_segments_far_from_start_keep_precision():
    """Segments of ~2 rows near position 2^20 of positive contributions:
    a flat f32 cumsum has grown to ~1e6 there and loses ~0.06 on each
    boundary difference; the two-level cumsum stays within its chunk's
    magnitude."""
    n, t = 1 << 20, 1 << 19
    ids = np.sort(np.random.default_rng(0).integers(0, t, n)).astype(np.int32)
    contrib = np.ones(n, np.float32) + np.float32(1e-3) * np.arange(
        n, dtype=np.float32) / n
    want = np.bincount(ids, weights=contrib.astype(np.float64), minlength=t)
    plan = make_gather_plan(torch.tensor(ids), t)
    got = segment_sum_by_plan(torch.tensor(contrib), plan).numpy()
    err = np.abs(got - want).max()
    assert err < _CHUNK * 4e-7, err

    flat = np.concatenate([[0], np.cumsum(contrib, dtype=np.float32)])
    pos = np.searchsorted(ids, np.arange(t + 1))
    flat_err = np.abs((flat[pos[1:]] - flat[pos[:-1]]) - want).max()
    assert flat_err > 100 * err, (flat_err, err)


def test_plan_rejects_ids_outside_the_table():
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        make_gather_plan(torch.tensor([0, 3, 10], dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        plan_gather(torch.zeros(4), torch.zeros(3, dtype=torch.int32), None)


def test_gather_launcher_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only; it refuses CPU ones before
    building or launching anything."""
    from careless_tpu_torch import kernels
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather(torch.zeros(4), torch.zeros(2, dtype=torch.int32))


_TABLE, _IDS = torch.zeros(512), torch.zeros(256, dtype=torch.int32)


@pytest.mark.parametrize("table,ids", [
    (_TABLE, _IDS.long()), (_TABLE.double(), _IDS), (_TABLE[::2], _IDS),
    (_TABLE, _IDS[::2])], ids=["int64_ids", "f64_table", "strided_table",
                               "strided_ids"])
def test_gather_launchers_refuse_wrong_inputs(table, ids):
    """K2's and K5's launchers check type and contiguity on every call
    (and the device: these are CPU tensors) and raise before building or
    launching anything."""
    from careless_tpu_torch import kernels
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather(table, ids)
    ids2d = ids.reshape(-1, 128 if ids.is_contiguous() else 64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather_stream(table, ids2d, torch.zeros(2, dtype=torch.int32),
                              2, 1)


def _plan_id_fields(plan):
    """(name, tensor, bound) of every id tensor a plan gathers by."""
    n = plan.ids.numel()
    out = [("ids", plan.ids, plan.table_size),
           ("pos", plan.pos, n + 1),
           ("cp_ids", plan.cp_ids, 2 * ((n + _CHUNK) // _CHUNK))]
    if plan.perm is not None:
        out.append(("perm", plan.perm, n))
    for w, size in ((plan.window, plan.table_size), (plan.perm_plan, n)):
        if w is not None:
            rows = -(-size // 128)
            out += [("ids2d", w.ids2d, size),
                    ("bases", w.bases, max(rows - w.window, 0) + 1)]
    return out


def _chain_plan_id_fields(plan):
    return [("sigma", plan.sigma, plan.table_size),
            ("sigma_inv", plan.sigma_inv, plan.table_size)] + \
        _plan_id_fields(plan.inner)


@pytest.mark.parametrize("sort", [True, False])
def test_plan_ids_are_int32_contiguous_and_in_range(sort, monkeypatch):
    """The plans own the gathers' ids and check them once, when built, so
    that the launchers need not: int32, contiguous, inside their tables
    (with the stream window, at a lowered VMEM cap)."""
    monkeypatch.setattr(tpg, "MAX_TABLE_ROWS", 2)
    rng = np.random.default_rng(3)
    plan = make_gather_plan(torch.tensor(_ids(rng, 5000, 700, sort, False)),
                            700)
    assert plan.stream and (plan.perm is None) == sort
    for name, t, bound in _plan_id_fields(plan):
        assert t.dtype == torch.int32 and t.is_contiguous(), name
        assert 0 <= int(t.min()) and int(t.max()) < bound, name


def test_chain_plan_ids_are_int32_contiguous_and_in_range(stream):
    refl_id, hid, n_refl = _chain_inputs()
    plan = tpg.make_chain_gather_plan(torch.tensor(refl_id),
                                      torch.tensor(hid), n_refl)
    assert plan.inner.perm_plan.stream == stream
    for name, t, bound in _chain_plan_id_fields(plan):
        assert t.dtype == torch.int32 and t.is_contiguous(), name
        assert 0 <= int(t.min()) and int(t.max()) < bound, name


def test_window_plan_rejects_bases_past_the_table():
    """A window plan whose windows run past its table, or whose ids do,
    raises when it is built."""
    ids2d = torch.zeros((64, 128), dtype=torch.int32)
    ok = dict(ids2d=ids2d, bases=torch.tensor([4], dtype=torch.int32),
              window=6, block_rows=64, stream=True, table_size=10 * 128)
    tpg.WindowPlan(**ok)
    with pytest.raises(ValueError, match="bases"):
        tpg.WindowPlan(**{**ok, "bases": torch.tensor([5],
                                                      dtype=torch.int32)})
    with pytest.raises(ValueError, match="bases"):
        tpg.WindowPlan(**{**ok, "bases": torch.tensor([-1],
                                                      dtype=torch.int32)})
    with pytest.raises(ValueError, match="ids2d"):
        tpg.WindowPlan(**{**ok, "ids2d": ids2d + 10 * 128})
    with pytest.raises(ValueError, match="ids2d"):
        tpg.WindowPlan(**{**ok, "ids2d": ids2d.long()})


def test_plans_reject_ids_of_another_type_or_range():
    ids = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    plan = make_gather_plan(ids, 6)
    with pytest.raises(ValueError, match="perm"):
        tpg.GatherPlan(**{**plan.__dict__,
                          "perm": torch.tensor([0, 1, 2, 4],
                                               dtype=torch.int32)})
    with pytest.raises(ValueError, match="ids"):
        tpg.GatherPlan(**{**plan.__dict__, "ids": ids.long()})


def test_table_gather_on_cpu_is_the_plain_version():
    table = torch.arange(7, dtype=torch.float32)
    ids = torch.tensor([6, 0, 0, 3], dtype=torch.int32)
    assert torch.equal(table_gather(table, ids), plain_gather(table, ids))
    assert table_gather(table, ids).tolist() == [6.0, 0.0, 0.0, 3.0]


# ---------------------------------------------------------------------------
# The Laue pieces: K5's plain version, the chain gather plan, plan_convolve
# ---------------------------------------------------------------------------
def _swap_perm(n, offsets=(3, 17, 111)):
    """tests/ops/test_chain_layout.py:257-261's quasi-identity permutation."""
    perm = np.arange(n, dtype=np.int64)
    for off in offsets:
        i = np.arange(0, n - off, off * 13)
        perm[i], perm[i + off] = perm[i + off].copy(), perm[i].copy()
    return perm.astype(np.int32)


def _stream_cases():
    rng = np.random.default_rng(21)
    # the hardware test's swap permutation, at a CPU size
    perm = _swap_perm(40_000)
    ids2d, bases, w = _plan_windows(perm, 40_000, max_chunks=160,
                                    max_rows=1 << 20)
    yield "swap", rng.normal(size=40_000), ids2d, bases, w, 64
    # an id outside its tile's window gives 0
    bad = ids2d.copy()
    bad[0, 5] = 39_999
    yield "outside", rng.normal(size=40_000), bad, bases, w, 64
    # a 300-entry table read through 5-row (640-entry) windows: past its
    # end it reads 0
    ids = rng.integers(0, 640, (4 * 16, 128)).astype(np.int32)
    yield ("past_end", rng.normal(size=300), ids,
           np.zeros(4, np.int32), 5, 16)


@pytest.mark.parametrize("case", list(_stream_cases()),
                         ids=lambda c: c[0])
def test_plain_windowed_gather_matches_jax_stream(case):
    """plain_windowed_gather against careless_tpu's windowed_gather_stream
    (interpret mode on the CPU), bit for bit."""
    _, table, ids2d, bases, window, block_rows = case
    table = table.astype(np.float32)
    want = np.asarray(jax_windowed_gather_stream(
        jnp.asarray(table), jnp.asarray(ids2d), jnp.asarray(bases), window,
        block_rows))
    got = windowed_gather_stream(torch.tensor(table), torch.tensor(ids2d),
                                 torch.tensor(bases), window, block_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    if case[0] == "swap":
        perm = _swap_perm(40_000)
        np.testing.assert_array_equal(got.numpy()[:40_000], table[perm])
    if case[0] == "outside":
        assert got[5].item() == 0.0 and table[39_999] != 0.0
    if case[0] == "past_end":
        flat = ids2d.reshape(-1)
        assert (flat >= 300).any()
        np.testing.assert_array_equal(
            got.numpy(), np.where(flat < 300, table[np.minimum(flat, 299)],
                                  0.0))


def test_windowed_gather_rejects_mismatched_tiles():
    with pytest.raises(ValueError, match="tiles"):
        windowed_gather_stream(torch.zeros(10), torch.zeros(
            (3, 128), dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            2, 64)


def test_gather_stream_launcher_refuses_cpu_tensors():
    from careless_tpu_torch import kernels
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather_stream(torch.zeros(256),
                              torch.zeros((64, 128), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 2, 64)


def _chain_inputs(n=3000, n_refl=400):
    from chip_smoke import build_problem
    arrays, _, _ = build_problem(0, n, n_refl, 9, 3, laue=True)
    j = JInputs.from_arrays(*arrays).sorted_by_harmonic(n_refl)
    return np.asarray(j.refl_id), np.asarray(j.harmonic_id), n_refl


@pytest.fixture(params=[False, True], ids=["cap", "lowered_cap"])
def stream(request, monkeypatch):
    """At the lowered VMEM cap (8 rows) the 3000-row observation axis is
    past it in both packages and the plans stream."""
    if request.param:
        monkeypatch.setattr(jpg, "MAX_TABLE_ROWS", 8)
        monkeypatch.setattr(tpg, "MAX_TABLE_ROWS", 8)
    return request.param


def _same_window(got, ids2d, bases, window, stream, block_rows):
    np.testing.assert_array_equal(got.ids2d.numpy(), np.asarray(ids2d))
    np.testing.assert_array_equal(got.bases.numpy(), np.asarray(bases))
    assert (got.window, got.stream, got.block_rows) == (window, stream,
                                                        block_rows)


def test_chain_gather_plan_matches_jax(stream):
    refl_id, hid, n_refl = _chain_inputs()
    want = jpg.make_chain_gather_plan(refl_id, hid, n_refl)
    got = tpg.make_chain_gather_plan(torch.tensor(refl_id), torch.tensor(hid),
                                     n_refl)
    assert isinstance(got, tpg.ChainGatherPlan)
    n = len(refl_id)
    np.testing.assert_array_equal(got.sigma.numpy(), want.sigma)
    np.testing.assert_array_equal(got.sigma_inv.numpy(), want.sigma_inv)
    np.testing.assert_array_equal(got.inner.ids.numpy(),
                                  np.asarray(want.inner.ids2d).reshape(-1)[:n])
    np.testing.assert_array_equal(got.inner.perm.numpy(), want.inner.perm)
    np.testing.assert_array_equal(got.inner.starts.numpy(), want.inner.starts)
    jp = want.inner.perm_plan
    _same_window(got.inner.perm_plan, jp.ids2d, jp.bases, jp.window,
                 jp.stream, jp.block_rows)
    assert jp.stream == stream
    # the harmonic convolve plan streams past the cap, with JAX's windows
    jh = jpg.make_gather_plan(hid, n)
    th = tpg.make_gather_plan(torch.tensor(hid), n)
    assert th.stream == jh.stream == stream
    if stream:
        _same_window(th.window, jh.ids2d, jh.bases, jh.window, True, 64)
    else:
        assert th.window is None


def test_chain_gather_and_convolve_match_jax(stream):
    """Values and table gradients of plan_gather through the chain plan and
    of plan_convolve through the harmonic plan (sums in another order: the
    JAX package's one-hot histogram and cumsums; atol 1e-5 on O(1)
    cotangents)."""
    refl_id, hid, n_refl = _chain_inputs()
    n = len(refl_id)
    rng = np.random.default_rng(22)
    table = rng.normal(size=n_refl).astype(np.float32)
    value = rng.normal(size=n).astype(np.float32)
    ct = rng.normal(size=n).astype(np.float32)
    jplan = jpg.make_chain_gather_plan(refl_id, hid, n_refl)
    hplan = jpg.make_gather_plan(hid, n)
    cases = [
        (lambda x: jpg.plan_gather(x, jnp.asarray(refl_id), jplan),
         lambda x: tpg.plan_gather(x, torch.tensor(refl_id),
                                   tpg.make_chain_gather_plan(
                                       torch.tensor(refl_id),
                                       torch.tensor(hid), n_refl)), table),
        (lambda x: jpg.plan_convolve(x, jnp.asarray(hid), hplan),
         lambda x: tpg.plan_convolve(x, torch.tensor(hid),
                                     tpg.make_gather_plan(torch.tensor(hid),
                                                          n)), value)]
    for jfn, tfn, x in cases:
        out_j, vjp = jax.vjp(jfn, jnp.asarray(x))
        (g_j,) = vjp(jnp.asarray(ct))
        xt = torch.tensor(x, requires_grad=True)
        out = tfn(xt)
        (g,) = torch.autograd.grad(out, xt, torch.tensor(ct))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5,
                                   atol=1e-5)
