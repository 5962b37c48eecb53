"""The port's MLP trunk + head (K1) against careless_tpu's fused kernel.

The JAX side runs `careless_tpu.ops.fused_mlp.fused_mlp_trunk_head`, whose
Pallas kernel runs in interpret mode on the CPU; the port's CPU path is the
plain PyTorch version. Same inputs, made with numpy from a seed.
Tolerances: the JAX kernel multiplies 128-lane block-diagonal tiles, so
its sums run in another order than the port's f32 matmuls (forward rtol
1e-5); gradients are sums over all observations (1e-5 of the largest
entry of each tensor).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.ops.fused_mlp import \
    fused_mlp_trunk_head as jax_trunk_head
from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk_head,
                                              pack_params, plain_trunk_head)

torch.set_num_threads(2)


def _problem(n, d, w, n_layers, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    layers = []
    d_in = d
    for _ in range(n_layers):
        layers.append({
            "w": (np.eye(d_in, w) + 0.3 / np.sqrt(d_in)
                  * rng.normal(size=(d_in, w))).astype(np.float32),
            "b": (0.1 * rng.normal(size=w)).astype(np.float32)})
        d_in = w
    out = {"w": (rng.normal(size=(w, 2)) / np.sqrt(w)).astype(np.float32),
           "b": (0.1 * rng.normal(size=2)).astype(np.float32)}
    gl = rng.normal(size=n).astype(np.float32)
    gr = rng.normal(size=n).astype(np.float32)
    return x, layers, out, gl, gr


def _torch_tree(layers, out, device="cpu"):
    t_layers = [{k: torch.tensor(v, device=device, requires_grad=True)
                 for k, v in layer.items()} for layer in layers]
    t_out = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in out.items()}
    leaves = [t for layer in t_layers for t in (layer["w"], layer["b"])]
    return t_layers, t_out, leaves + [t_out["w"], t_out["b"]]


def _assert_grads_close(got, want, rel=1e-5):
    for g, r in zip(got, want):
        g, r = np.asarray(g), np.asarray(r)
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() <= rel * scale, (np.abs(g - r).max(),
                                                    scale)


@pytest.mark.parametrize("n,d,w,n_layers", [
    (1000, 10, 10, 4),   # the main path's width
    (777, 7, 12, 3),     # d != w
    (1531, 10, 10, 2),   # prime N
])
def test_trunk_head_matches_jax(n, d, w, n_layers):
    x, layers, out, gl, gr = _problem(n, d, w, n_layers, seed=n)

    def f_jax(layers, out):
        loc, raw = jax_trunk_head(jnp.asarray(x), layers, out, 0.01)
        return jnp.sum(loc * gl) + jnp.sum(raw * gr), (loc, raw)

    (_, (loc_j, raw_j)), (g_layers, g_out) = jax.value_and_grad(
        f_jax, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, layers), jax.tree.map(jnp.asarray, out))

    t_layers, t_out, leaves = _torch_tree(layers, out)
    loc, raw = fused_mlp_trunk_head(torch.tensor(x), t_layers, t_out, 0.01)
    np.testing.assert_allclose(loc.detach().numpy(), np.asarray(loc_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(raw_j),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(
        (loc * torch.tensor(gl)).sum() + (raw * torch.tensor(gr)).sum(),
        leaves)
    want = [a for layer in g_layers for a in (layer["w"], layer["b"])]
    want += [g_out["w"], g_out["b"]]
    _assert_grads_close([g.numpy() for g in grads], want)


def _emulate_kernel(x, w_flat, b_flat, kw, n_layers, leak):
    """numpy reading of csrc/trunk.cu's flat parameter layout."""
    d_in = x.shape[1]
    w_flat, b_flat = w_flat.astype(np.float64), b_flat.astype(np.float64)
    h = x.astype(np.float64)
    off = 0
    for layer in range(n_layers):
        rows = d_in if layer == 0 else kw
        wl = w_flat[off:off + rows * kw].reshape(rows, kw)
        off += rows * kw
        h = h @ wl + b_flat[layer * kw:(layer + 1) * kw]
        h = np.where(h >= 0, h, leak * h)
    y = h @ w_flat[off:off + 2 * kw].reshape(kw, 2) + b_flat[-2:]
    return y[:, 0], y[:, 1]


@pytest.mark.parametrize("w", [10, 17])
def test_packed_layout_is_exact(w):
    """The flat, zero-padded layout the kernel reads computes the same
    trunk; width 17 pads to the kernel's instantiated width 20."""
    x, layers, out, _, _ = _problem(300, 6, w, 3, seed=w)
    kw = kernels.trunk_width(w)
    assert kw >= w and kw in kernels.TRUNK_WIDTHS
    t_layers, t_out, _ = _torch_tree(layers, out)
    w_flat, b_flat = pack_params(t_layers, t_out, kw)
    n_w = 6 * kw + 2 * kw * kw + 2 * kw
    assert w_flat.shape == (n_w,) and b_flat.shape == (3 * kw + 2,)
    loc_e, raw_e = _emulate_kernel(x, w_flat.detach().numpy(),
                                   b_flat.detach().numpy(), kw, 3, 0.01)
    loc_p, raw_p = plain_trunk_head(torch.tensor(x), t_layers, t_out, 0.01)
    np.testing.assert_allclose(loc_e, loc_p.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(raw_e, raw_p.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_trunk_width_cap():
    assert kernels.trunk_width(10) == 10
    assert kernels.trunk_width(21) == 24
    with pytest.raises(ValueError, match="cap"):
        kernels.trunk_width(33)


def test_trunk_launcher_refuses_cpu_tensors():
    x, layers, out, _, _ = _problem(50, 4, 4, 2, seed=0)
    t_layers, t_out, _ = _torch_tree(layers, out)
    w, b = pack_params(t_layers, t_out, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.trunk_fwd(torch.tensor(x), w.detach(), b.detach(), 4, 2, 0.01)
