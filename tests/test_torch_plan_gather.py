"""The port's planned gather (K2 forward, planned segment-sum backward)
against careless_tpu.ops.plan_gather, np.bincount and a flat cumsum.

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

from careless_tpu.ops.plan_gather import make_gather_plan as jax_plan
from careless_tpu.ops.plan_gather import plan_gather as jax_plan_gather
from careless_tpu_torch.ops.plan_gather import (_CHUNK, make_gather_plan,
                                                plan_gather,
                                                segment_sum_by_plan)
from careless_tpu_torch.ops.table_gather import plain_gather, table_gather

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


def test_table_gather_on_cpu_is_the_plain_version():
    table = torch.arange(7, dtype=torch.float32)
    ids = torch.tensor([6, 0, 0, 3], dtype=torch.int32)
    assert torch.equal(table_gather(table, ids), plain_gather(table, ids))
    assert table_gather(table, ids).tolist() == [6.0, 0.0, 0.0, 3.0]
