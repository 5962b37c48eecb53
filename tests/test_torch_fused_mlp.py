"""The port's MLP trunk (K1), with and without its head, in f32 and bf16,
against careless_tpu's fused kernel.

The JAX side runs `careless_tpu.ops.fused_mlp.fused_mlp_trunk_head` and
`fused_mlp_trunk`, whose Pallas kernels run in interpret mode on the CPU;
the port's CPU path is the plain PyTorch version. Same inputs, made with
numpy from a seed. Tolerances: the JAX kernel multiplies 128-lane
block-diagonal tiles, so its sums run in another order than the port's f32
matmuls (forward rtol 1e-5, or 1e-5 of the output's largest entry);
gradients are sums over all observations (1e-5 of the largest entry of
each tensor). In bf16 the products of rounded operands are exact, so the
same tolerances hold, and each bf16 case checks that the f32 answer lies
more than 100 times the tolerance away (the bf16 rounding is applied).

bf16 rounding is discontinuous. The two packages sum each product in
another order, so their f32 sums differ in the last bit; where such a sum
lies on the two sides of a midpoint between bf16 values, that observation
takes another path through the remaining layers (and a pre-activation
near zero may change sign), and values and gradients then differ far past
f32 rounding, in either direction and by chance. At 20 layers many seeds
have such a straddle somewhere; the bf16 cases' seeds were checked to have
none, so that they hold the algorithm at f32 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from careless_tpu.ops.fused_mlp import fused_mlp_trunk as jax_trunk
from careless_tpu.ops.fused_mlp import \
    fused_mlp_trunk_head as jax_trunk_head
from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk,
                                              fused_mlp_trunk_head,
                                              pack_params, plain_trunk,
                                              plain_trunk_head)

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
    """The layers (and the head, unless out is None) as tensors needing
    grad, and their leaves in the JAX tree's order."""
    t_layers = [{k: torch.tensor(v, device=device, requires_grad=True)
                 for k, v in layer.items()} for layer in layers]
    leaves = [t for layer in t_layers for t in (layer["w"], layer["b"])]
    if out is None:
        return t_layers, None, leaves
    t_out = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in out.items()}
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


def _trunk_and_grads(fn, x, layers, out, cts, bf16):
    """fn's outputs and the gradients of sum(outputs * cts) in every
    parameter: fn is the port's trunk (out None) or trunk + head."""
    t_layers, t_out, leaves = _torch_tree(layers, out)
    if out is None:
        ys = (fn(torch.tensor(x), t_layers, 0.01, bf16=bf16),)
    else:
        ys = fn(torch.tensor(x), t_layers, t_out, 0.01, bf16=bf16)
    obj = sum((y * torch.tensor(c)).sum() for y, c in zip(ys, cts))
    grads = torch.autograd.grad(obj, leaves)
    return [y.detach().numpy() for y in ys], [g.numpy() for g in grads]


def _jax_trunk_and_grads(x, layers, out, cts, bf16):
    def f(layers, out):
        if out is None:
            ys = (jax_trunk(jnp.asarray(x), layers, 0.01, bf16=bf16),)
        else:
            ys = jax_trunk_head(jnp.asarray(x), layers, out, 0.01,
                                bf16=bf16)
        return sum(jnp.sum(y * c) for y, c in zip(ys, cts)), ys

    args = (jax.tree.map(jnp.asarray, layers),
            None if out is None else jax.tree.map(jnp.asarray, out))
    (_, ys), grads = jax.value_and_grad(
        f, argnums=(0,) if out is None else (0, 1), has_aux=True)(*args)
    want = [a for layer in grads[0] for a in (layer["w"], layer["b"])]
    if out is not None:
        want += [grads[1]["w"], grads[1]["b"]]
    return [np.asarray(y) for y in ys], [np.asarray(g) for g in want]


def _max_rel(got, want):
    return max(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("n,d,w,n_layers,seed", [
    (2000, 10, 10, 20, 2),   # the default model's width and depth
    (500, 3, 5, 2, 0),       # narrow, d != w
])
def test_trunk_matches_jax(n, d, w, n_layers, seed, head, bf16):
    """fused_mlp_trunk (head False) and fused_mlp_trunk_head against JAX's
    kernels, values and every parameter gradient, f32 and bf16 (seeds
    without a bf16 straddle: see the module docstring)."""
    x, layers, out, gl, gr = _problem(n, d, w, n_layers, seed=seed)
    rng = np.random.default_rng(seed + 7)
    cts = ((gl, gr) if head else
           (rng.normal(size=(n, w)).astype(np.float32),))
    out = out if head else None
    fn = fused_mlp_trunk_head if head else fused_mlp_trunk
    ys, grads = _trunk_and_grads(fn, x, layers, out, cts, bf16)
    ys_j, grads_j = _jax_trunk_and_grads(x, layers, out, cts, bf16)
    assert [y.shape for y in ys] == [y.shape for y in ys_j]
    tol = 1e-5
    assert _max_rel(ys, ys_j) <= tol
    assert _max_rel(grads, grads_j) <= tol
    if bf16:
        ys_f, grads_f = _trunk_and_grads(fn, x, layers, out, cts, False)
        assert _max_rel(ys_f, ys_j) > 100 * tol
        assert _max_rel(grads_f, grads_j) > 100 * tol


def test_bf16_backward_rounds_operands_not_results():
    """Autograd through the casts rounds each gradient product's result;
    the kernel's backward rounds its operands. Only the latter is JAX's
    kernel within 1e-5 (measured: the casts err 1e-3 to 1e-2)."""
    x, layers, out, gl, gr = _problem(1000, 6, 6, 4, seed=3)
    _, want = _jax_trunk_and_grads(x, layers, out, (gl, gr), True)
    _, grads = _trunk_and_grads(fused_mlp_trunk_head, x, layers, out,
                                (gl, gr), True)
    assert _max_rel(grads, want) <= 1e-5

    def through_casts(x, layers, out, leak, bf16):
        def r(t):
            return t.bfloat16().float()
        h = x
        for layer in layers:
            h = r(h) @ r(layer["w"]) + layer["b"]
            h = torch.where(h >= 0, h, leak * h)
        y = r(h) @ r(out["w"]) + out["b"]
        return y[:, 0], y[:, 1]
    _, cast_grads = _trunk_and_grads(through_casts, x, layers, out,
                                     (gl, gr), True)
    assert _max_rel(cast_grads, want) > 1e-4


def _emulate_kernel(x, w_flat, b_flat, kw, n_layers, leak, head=True):
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
    if not head:
        assert off == w_flat.size and n_layers * kw == b_flat.size
        return h
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


@pytest.mark.parametrize("w", [10, 17])
def test_packed_layout_without_head_is_exact(w):
    """The headless layout (no head weights or biases) computes the same
    trunk; the kernel's padded columns stay zero and are sliced away."""
    x, layers, _, _, _ = _problem(300, 6, w, 3, seed=w + 1)
    kw = kernels.trunk_width(w)
    t_layers, _, _ = _torch_tree(layers, None)
    w_flat, b_flat = pack_params(t_layers, None, kw)
    assert w_flat.shape == (6 * kw + 2 * kw * kw,)
    assert b_flat.shape == (3 * kw,)
    h = _emulate_kernel(x, w_flat.detach().numpy(), b_flat.detach().numpy(),
                        kw, 3, 0.01, head=False)
    assert np.all(h[:, w:] == 0)
    np.testing.assert_allclose(
        h[:, :w], plain_trunk(torch.tensor(x), t_layers, 0.01).detach(
        ).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,w,n_layers,head,tile", [
    (10, 10, 20, True, 64),     # the main path keeps its 64-row tile
    (10, 10, 20, False, 64),
    (24, 24, 20, True, 32),     # refused at 64 rows before
    (28, 28, 20, True, 32),     # the positional-encoding example, -L 6
    (32, 32, 20, True, 16),
    (128, 32, 20, True, 8),
    (128, 32, 20, False, 8),
])
def test_trunk_backward_tile(d, w, n_layers, head, tile):
    """The backward takes the tallest tile that fits in a block's 227 KB;
    widths up to 32 at 20 layers fit for d_in up to 128."""
    kw = kernels.trunk_width(w)
    assert kernels.trunk_bwd_tile(d, kw, n_layers, head) == tile
    assert (kernels.trunk_smem(d, kw, n_layers, head, tile)
            <= kernels.MAX_SMEM_PER_BLOCK)
    if tile < 64:
        assert (kernels.trunk_smem(d, kw, n_layers, head, 2 * tile)
                > kernels.MAX_SMEM_PER_BLOCK)


def test_trunk_backward_tile_refuses_past_the_shortest():
    with pytest.raises(ValueError, match="shared memory"):
        kernels.trunk_bwd_tile(1024, 32, 20, True)


def test_trunk_launch_keys():
    keys = {kernels.trunk_key(d, h, b) for d in ("fwd", "bwd")
            for h in (True, False) for b in (True, False)}
    assert len(keys) == 8 and keys <= set(kernels.LAUNCHES)
    assert kernels.trunk_key("fwd", True, False) == "trunk_fwd"


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
