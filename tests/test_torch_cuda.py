"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips without a card. The file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: gathers copy, so they are exact; the trunk sums in another
order than cuBLAS (1e-5 of the output scale, and of each gradient
tensor's largest entry); Philox words are exact and normals within 2e-5
(log/cos may round differently, |x| <= 5.8).
"""
import numpy as np
import pytest
import torch

from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_elbo import plain_prng_normal
from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk_head,
                                              plain_trunk_head)
from careless_tpu_torch.ops.plan_gather import make_gather_plan, plan_gather
from careless_tpu_torch.ops.table_gather import plain_gather, table_gather

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
                                "philox_normal": 0}
