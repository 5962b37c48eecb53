"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips without a card. The file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: gathers (K2, K5) copy, so they are exact; the trunk sums in another
order than cuBLAS (1e-5 of the output scale, and of each gradient
tensor's largest entry); Philox words are exact and normals within 2e-5
(log/cos may round differently, |x| <= 5.8). K4 against its plain
versions on the same inputs: the sum at rtol 1e-5 (f32 sums over 200k
observations in another order), per-observation gradients within 1e-5 of
each tensor's largest entry (the kernel fuses multiply-adds), the Ev11
sums at rtol 1e-4; K4 with its own Philox equals K4 fed K3's normals bit
for bit, and repeats bit for bit.
"""
import numpy as np
import pytest
import torch

from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_elbo import (
    plain_fused_likelihood_grads, plain_fused_likelihood_sum,
    plain_prng_normal, studentt_log_norm)
from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk_head,
                                              plain_trunk_head)
from careless_tpu_torch.ops.plan_gather import (_plan_windows,
                                                make_gather_plan, plan_gather)
from careless_tpu_torch.ops.table_gather import (plain_gather,
                                                 plain_windowed_gather,
                                                 table_gather,
                                                 windowed_gather_stream)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _trunk(n, d, w, n_layers, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    x = t(rng.normal(size=(n, d)))
    layers = []
    d_in = d
    for _ in range(n_layers):
        layers.append({
            "w": t(np.eye(d_in, w) + 0.3 / np.sqrt(d_in)
                   * rng.normal(size=(d_in, w))).requires_grad_(True),
            "b": t(0.1 * rng.normal(size=w)).requires_grad_(True)})
        d_in = w
    out = {"w": t(rng.normal(size=(w, 2)) / np.sqrt(w)).requires_grad_(True),
           "b": t(0.1 * rng.normal(size=2)).requires_grad_(True)}
    leaves = [p for layer in layers for p in (layer["w"], layer["b"])]
    return (x, layers, out, leaves + [out["w"], out["b"]],
            t(rng.normal(size=n)), t(rng.normal(size=n)))


@pytest.mark.parametrize("n,d,w,n_layers", [
    (100_003, 10, 10, 20),   # the main path's width and depth
    (5_001, 7, 17, 3),       # padded to the instantiated width 20
    (63, 3, 4, 1),           # less than one backward tile
])
def test_trunk_kernel_matches_plain(cuda, n, d, w, n_layers):
    x, layers, out, leaves, gl, gr = _trunk(n, d, w, n_layers, cuda, n)

    def run(fn):
        loc, raw = fn(x, layers, out, 0.01)
        g = torch.autograd.grad((loc * gl).sum() + (raw * gr).sum(), leaves)
        return loc.detach(), raw.detach(), g

    loc_k, raw_k, g_k = run(fused_mlp_trunk_head)
    _, _, g_k2 = run(fused_mlp_trunk_head)
    loc_p, raw_p, g_p = run(plain_trunk_head)
    scale = max(loc_p.abs().max().item(), raw_p.abs().max().item(), 1.0)
    assert (loc_k - loc_p).abs().max().item() <= 1e-5 * scale
    assert (raw_k - raw_p).abs().max().item() <= 1e-5 * scale
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
    for a, b in zip(g_k, g_p):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_trunk_kernel_dx_when_asked(cuda):
    x, layers, out, _, gl, gr = _trunk(2_000, 6, 8, 4, cuda, 1)
    grads = []
    for fn in (fused_mlp_trunk_head, plain_trunk_head):
        xr = x.clone().requires_grad_(True)
        loc, raw = fn(xr, layers, out, 0.01)
        (g,) = torch.autograd.grad((loc * gl).sum() + (raw * gr).sum(), xr)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 1_000_003])
def test_gather_kernel_matches_plain(cuda, n):
    """K2 copies exactly, including the ragged tail and unaligned ids; the
    planned backward matches an f64 scatter-add."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn(50_000, generator=gen, device=cuda)
    ids = torch.randint(0, 50_000, (n + 1,), generator=gen, device=cuda,
                        dtype=torch.int32)
    for view in (ids[:n], ids[1:]):
        assert torch.equal(table_gather(table, view),
                           plain_gather(table, view))
    plan = make_gather_plan(ids, 50_000)
    tab = table.clone().requires_grad_(True)
    ct = torch.randn(n + 1, generator=gen, device=cuda)
    (g,) = torch.autograd.grad(plan_gather(tab, ids, plan), tab, ct)
    want = torch.zeros(50_000, dtype=torch.float64, device=cuda)
    want.index_add_(0, ids.long(), ct.double())
    torch.testing.assert_close(g.double(), want, rtol=0, atol=1e-4)


def test_philox_kernel_matches_plain(cuda):
    n, seed, offset = 1_000_003, 0x0123456789ABCDEF, 5 * 2 ** 32
    out_k, bits_k = kernels.philox_normal(n, seed, offset, cuda,
                                          with_bits=True)
    out_p, bits_p = plain_prng_normal(n, seed, offset, cuda, with_bits=True)
    assert torch.equal(bits_k, bits_p)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=2e-5)


def test_launch_counts_move_only_on_launch(cuda):
    kernels.reset_launches()
    table = torch.randn(10, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    table_gather(table, ids)
    plain_gather(table, ids)
    plain_prng_normal(8, 1, 0, cuda)
    assert kernels.LAUNCHES == {"trunk_fwd": 0, "trunk_bwd": 0, "gather": 1,
                                "philox_normal": 0, "fused_ll_fwd": 0,
                                "fused_ll_bwd": 0, "gather_stream": 0}


K4_KINDS = [("normal", 0.0), ("studentt", 4.0), ("laplace", 0.0),
            ("normal_ev11", 0.0), ("studentt_ev11", 4.0)]


def _k4_inputs(n, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    ins = dict(loc=t(rng.normal(1.0, 0.3, n)),
               scale=t(rng.uniform(0.05, 0.3, n)),
               a=t(rng.uniform(-1.5, 1.5, n)), f=t(rng.uniform(0.2, 2.0, n)),
               iobs=t(rng.gamma(2.0, 1.0, n)), sig=t(rng.uniform(0.1, 1, n)))
    return (ins, t(rng.random(n) > 0.1), t([1.3, 0.2, 0.7]),
            t(rng.normal(size=n)))


@pytest.mark.parametrize("kind,dof", K4_KINDS)
@pytest.mark.parametrize("with_noise", [True, False])
def test_fused_ll_kernels_match_plain(cuda, kind, dof, with_noise):
    n, seed, offset = 200_003, 0xABCDEF0123 | (3 << 32), 200_003
    ins, mask, ev, noise = _k4_inputs(n, cuda, 7)
    args = list(ins.values())
    eps = noise if with_noise else plain_prng_normal(n, seed, offset, cuda)
    cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
               t_const=studentt_log_norm(dof) if dof else 0.0)
    ct = torch.tensor(0.5, device=cuda)
    out = kernels.fused_ll_fwd(*args, mask, noise if with_noise else None,
                               ev, **cfg)
    want = plain_fused_likelihood_sum(*args, mask, ev, eps, kind=kind,
                                      dof=dof)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=0)
    got = kernels.fused_ll_bwd(*args, mask, noise if with_noise else None,
                               ev, ct, **cfg)
    ref = plain_fused_likelihood_grads(*args, mask, ev, eps, ct, kind=kind,
                                       dof=dof)
    for g, r in zip(got[:4], ref[:4]):
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    if kind.endswith("_ev11"):
        torch.testing.assert_close(got[4], ref[4], rtol=1e-4, atol=0)
    else:
        assert got[4] is None and ref[4] is None
    again = kernels.fused_ll_bwd(*args, mask, noise if with_noise else None,
                                 ev, ct, **cfg)
    assert torch.equal(out, kernels.fused_ll_fwd(
        *args, mask, noise if with_noise else None, ev, **cfg))
    assert all(a is b or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kind,dof", [K4_KINDS[0], K4_KINDS[4]])
def test_fused_ll_philox_is_k3(cuda, kind, dof):
    """K4's in-kernel eps is bitwise K3's at the same (key, counter)."""
    n, seed, offset = 100_000, 0x1234 | (9 << 32), 3 * 100_000
    ins, _, ev, _ = _k4_inputs(n, cuda, 8)
    args = list(ins.values())
    cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
               t_const=studentt_log_norm(dof) if dof else 0.0)
    k3 = kernels.philox_normal(n, seed, offset, cuda)
    ct = torch.tensor(1.0, device=cuda)
    assert torch.equal(kernels.fused_ll_fwd(*args, None, None, ev, **cfg),
                       kernels.fused_ll_fwd(*args, None, k3, ev, **cfg))
    own = kernels.fused_ll_bwd(*args, None, None, ev, ct, **cfg)
    fed = kernels.fused_ll_bwd(*args, None, k3, ev, ct, **cfg)
    assert all(a is b or torch.equal(a, b) for a, b in zip(own, fed))


def _k5_case(name, rng):
    """(table, ids2d, bases, window, block_rows) of a K5 case."""
    if name == "swap":   # tests/ops/test_chain_layout.py:257-264
        n = 300_000
        perm = np.arange(n, dtype=np.int64)
        for off in (3, 17, 111):
            i = np.arange(0, n - off, off * 13)
            perm[i], perm[i + off] = perm[i + off].copy(), perm[i].copy()
        ids2d, bases, w = _plan_windows(perm.astype(np.int32), n,
                                        max_chunks=160, max_rows=1 << 20)
        return rng.normal(size=n), ids2d, bases, w, 64
    if name == "past_end":   # 5-row windows over a 300-entry table
        return (rng.normal(size=300),
                rng.integers(0, 640, (4 * 16, 128)), np.zeros(4), 5, 16)
    # a 160-row (80 KB) window, past the 48 KB default: ids spread over
    # each tile's window and beyond it, on either side
    n_tiles, t = 6, 300_000
    bases = rng.integers(0, t // 128 - 160, n_tiles)
    lo = np.repeat(bases * 128, 64 * 128)
    ids = lo + rng.integers(-500, 160 * 128 + 500, lo.shape)
    return rng.normal(size=t), np.clip(ids, 0, t - 1).reshape(-1, 128), \
        bases, 160, 64


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", ["swap", "past_end", "wide"])
def test_gather_stream_kernel_matches_plain(cuda, name, aligned):
    """K5 equals its plain version bit for bit, and the permutation on the
    swap case; an unaligned table (a view one entry in) is copied to an
    aligned one by the wrapper, which the kernel's 16-byte loads need."""
    rng = np.random.default_rng(len(name))
    table, ids2d, bases, window, block_rows = _k5_case(name, rng)
    buf = torch.tensor(np.concatenate([[0.0], table]).astype(np.float32),
                       device=cuda)
    table_t = buf[1:] if not aligned else buf[1:].clone()
    ids_t = torch.tensor(np.asarray(ids2d, np.int32), device=cuda)
    bases_t = torch.tensor(np.asarray(bases, np.int32), device=cuda)
    kernels.reset_launches()
    got = windowed_gather_stream(table_t, ids_t, bases_t, window, block_rows)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_stream"] == 1
    want = plain_windowed_gather(table_t, ids_t, bases_t, window, block_rows)
    assert torch.equal(got, want)
    if name == "swap":
        assert torch.equal(got[:table.shape[0]],
                           table_t[ids_t.reshape(-1)[:table.shape[0]].long()])
    if name == "wide":
        flat = ids_t.reshape(6, -1).long() - 128 * bases_t.long()[:, None]
        outside = (flat < 0) | (flat >= 160 * 128)
        assert outside.any() and (got.reshape(6, -1)[outside] == 0).all()


def test_gather_stream_refuses_a_window_past_shared_memory(cuda):
    window = kernels.MAX_SMEM_PER_BLOCK // 512 + 1
    with pytest.raises(ValueError, match="shared memory"):
        kernels.gather_stream(torch.zeros(1000, device=cuda),
                              torch.zeros((64, 128), dtype=torch.int32,
                                          device=cuda),
                              torch.zeros(1, dtype=torch.int32, device=cuda),
                              window, 64)
