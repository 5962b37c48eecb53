"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips without a card. The file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: gathers (K2, K5) copy, so they are exact; the trunk sums in another
order than cuBLAS (1e-5 of the output scale, and of each gradient
tensor's largest entry), in f32 and in bf16 against the bf16 plain version
(each product of rounded operands is exact; a bf16 rounding straddle, see
tests/test_torch_fused_mlp.py, would show as a failure here), the f32 and
bf16 backward kernels of their own within 1e-4 (their docstrings say
why); Philox words are exact and normals within 2e-5 (log/sincos may
round differently, |x| <= 5.8). K4 against its plain
versions on the same inputs: the sum at rtol 1e-5 (f32 sums over 200k
observations in another order), per-observation gradients within 1e-5 of
each tensor's largest entry (the kernel fuses multiply-adds), the Ev11
sums at rtol 1e-4; at chip_smoke's K4 recipe and seed 0, where the
Student-t dloc exceeds that by rounding alone, per observation within the
rounding of ipred (chip_smoke.studentt_check says why); K4 with its own
Philox equals K4 fed K3's normals bit for bit, and repeats bit for bit.
Multi-device training on the one card: a shard's K3 and K4 draws at its
unaligned offsets are the unsharded draw's slice bit for bit, and a
sharded run at NCCL world size 1 is the unsharded run bit for bit.
"""
import numpy as np
import pytest
import torch

from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_elbo import (
    plain_fused_likelihood_grads, plain_fused_likelihood_sum,
    plain_prng_normal, pointwise_ll, studentt_log_norm)
from careless_tpu_torch.kernels._build import library
from careless_tpu_torch.ops.fused_mlp import (fused_mlp_trunk,
                                              fused_mlp_trunk_head,
                                              pack_params, plain_trunk,
                                              plain_trunk_head, round_bf16)
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


def _run_trunk(fn, x, layers, out, cts, leaves, bf16):
    """fn's outputs and the gradients of sum(outputs * cts) in `leaves`:
    fn is a trunk + head (out given) or a trunk alone."""
    ys = (fn(x, layers, out, 0.01, bf16=bf16) if out is not None
          else (fn(x, layers, 0.01, bf16=bf16),))
    obj = sum((y * c).sum() for y, c in zip(ys, cts))
    return [y.detach() for y in ys], torch.autograd.grad(obj, leaves)


def _hold_trunk(n, d, w, n_layers, head, bf16, device, seed, dx=False,
                grad_tol=1e-5, val_tol=1e-5):
    """K1 (the head or the trunk alone, f32 or bf16) against its plain
    version, values within val_tol of the output scale and every gradient
    (dx too when asked) within grad_tol of each gradient's largest entry,
    and dW bitwise repeatable; each direction launched the kernel of
    kernels.trunk_route's route."""
    x, layers, out, leaves, gl, gr = _trunk(n, d, w, n_layers, device, seed)
    if dx:
        x.requires_grad_(True)
        leaves = [x] + leaves
    if head:
        fns, cts = (fused_mlp_trunk_head, plain_trunk_head), (gl, gr)
    else:
        fns = (fused_mlp_trunk, plain_trunk)
        cts = (torch.randn(n, w, device=device,
                           generator=torch.Generator(device).manual_seed(
                               seed)),)
        out, leaves = None, leaves[:-2]
    kernels.reset_launches()
    ys_k, g_k = _run_trunk(fns[0], x, layers, out, cts, leaves, bf16)
    _, g_k2 = _run_trunk(fns[0], x, layers, out, cts, leaves, bf16)
    torch.cuda.synchronize()
    route = kernels.trunk_route(d, w, n_layers, head, bf16)
    for direction, kernel in (("fwd", route.fwd), ("bwd", route.bwd)):
        assert kernels.LAUNCHES[kernels.trunk_key(
            direction, head, bf16, wide=kernel == kernels.TRUNK_WIDE)] == 2
    ys_p, g_p = _run_trunk(fns[1], x, layers, out, cts, leaves, bf16)
    assert [y.shape for y in ys_k] == [y.shape for y in ys_p]
    scale = max(max(y.abs().max().item() for y in ys_p), 1.0)
    for a, b in zip(ys_k, ys_p):
        assert (a - b).abs().max().item() <= val_tol * scale
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
    for a, b in zip(g_k, g_p):
        assert (a - b).abs().max().item() <= grad_tol * b.abs().max().item()


@pytest.mark.parametrize("n,d,w,n_layers", [
    (100_003, 10, 10, 20),   # the main path's width and depth
    (5_001, 7, 17, 3),       # padded to the instantiated width 20
    (63, 3, 4, 1),           # less than one backward tile
])
def test_trunk_kernel_matches_plain(cuda, n, d, w, n_layers):
    _hold_trunk(n, d, w, n_layers, True, False, cuda, n)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("n,d,w,n_layers", [
    (100_003, 10, 10, 20),   # the main path's width and depth
    (5_001, 7, 17, 3),       # padded to 20: the trunk-only output sliced
])
def test_trunk_variants_match_plain(cuda, n, d, w, n_layers, head, bf16):
    """The trunk-only and bf16 instantiations of K1."""
    _hold_trunk(n, d, w, n_layers, head, bf16, cuda, n + 1)


@pytest.mark.parametrize("d,w,head,tile", [
    (28, 28, True, 32),      # width 28 at d_in 28: refused before
    (128, 32, True, 8),      # width 32 at d_in 128: the shortest tile
    (128, 32, False, 8),
])
def test_trunk_wide_at_20_layers(cuda, d, w, head, tile):
    """Widths the 64-row backward could not hold at 20 layers run at a
    shorter tile, against the plain version."""
    assert kernels.trunk_bwd_tile(d, w, 20, head) == tile
    _hold_trunk(3_001, d, w, 20, head, False, cuda, d + w)


@pytest.mark.parametrize("d,w,n_layers", [(10, 10, 20), (128, 32, 20),
                                          (7, 20, 3)])
@pytest.mark.parametrize("head", [True, False])
def test_trunk_smem_matches_the_kernel(cuda, d, w, n_layers, head):
    """kernels.trunk_smem, which picks the tile, is csrc/trunk.cu's sum."""
    for tile in (0,) + kernels.TRUNK_BWD_TILES:
        assert kernels.trunk_smem(d, w, n_layers, head, tile) == \
            library().ct_trunk_smem(d, w, n_layers, int(head), tile)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("n,d,w,n_layers", [
    (5_001, 10, 33, 4),      # the narrowest wide width, padded to 48
    (5_001, 64, 64, 4),
    (5_001, 10, 128, 4),     # the JAX kernel's 128 lanes
    (5_001, 128, 128, 3),
    (3_001, 10, 32, 64),     # narrow, but its weights fit in no block
])
def test_wide_trunk_matches_plain(cuda, n, d, w, n_layers, head, bf16):
    """csrc/trunk_wide.cu in its four instantiations, both directions,
    against the plain version: values within 1e-4 of the output scale and
    gradients within 1e-3 of each one's largest entry (sums of up to 128
    products a layer and over 5k rows, in another order than cuBLAS's),
    and dW bit for bit the same from two runs."""
    route = kernels.trunk_route(d, w, n_layers, head, bf16)
    assert (route.fwd, route.bwd) == (kernels.TRUNK_WIDE,) * 2
    _hold_trunk(n, d, w, n_layers, head, bf16, cuda, n + w + n_layers,
                grad_tol=1e-3, val_tol=1e-4)


def _hold_wide_kernel(n, d, w, n_layers, head, bf16, device, seed):
    """csrc/trunk_wide.cu's launchers called directly (whatever
    kernels.trunk_route would take for the shape) against the plain
    version: values within 1e-4 of the output scale, each gradient within
    1e-3 of its largest entry (the kernel's flat dW and db mapped back to
    the layers through pack_params), dW and db bitwise repeatable."""
    x, layers, out, leaves, gl, gr = _trunk(n, d, w, n_layers, device, seed)
    kw = kernels.trunk_width(w)
    if not head:
        out, leaves = None, leaves[:-2]
    packed = pack_params(layers, out, kw)
    wflat, bflat = (t.detach() for t in packed)
    if head:
        cts = (gl, gr)
        ys_p = plain_trunk_head(x, layers, out, 0.01, bf16=bf16)
    else:
        cts = (torch.randn(n, w, device=device,
                           generator=torch.Generator(device).manual_seed(
                               seed)),)
        ys_p = (plain_trunk(x, layers, 0.01, bf16=bf16),)
    g_p = torch.autograd.grad(sum((y * c).sum() for y, c in zip(ys_p, cts)),
                              leaves)
    kernels.reset_launches()
    with torch.no_grad():
        ys_k = kernels.trunk_wide_fwd(x, wflat, bflat, kw, n_layers, 0.01,
                                      head=head, out_w=w, bf16=bf16)
    ys_k = ys_k if head else (ys_k,)
    dy = cts if head else cts[0]
    runs = [kernels.trunk_wide_bwd(x, wflat, bflat, dy, kw, n_layers, 0.01,
                                   False, head=head, bf16=bf16)[:2]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernels.trunk_key("fwd", head, bf16,
                                              wide=True)] == 1
    assert kernels.LAUNCHES[kernels.trunk_key("bwd", head, bf16,
                                              wide=True)] == 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    scale = max(max(y.abs().max().item() for y in ys_p), 1.0)
    for a, b in zip(ys_k, ys_p):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4 * scale
    g_k = torch.autograd.grad(packed, leaves, grad_outputs=runs[0])
    for a, b in zip(g_k, g_p):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("w", range(16, 129, 16))
def test_wide_kernel_at_every_kw(cuda, w, head):
    """csrc/trunk_wide.cu at each of its kernel widths, 3 layers, both
    directions, head and trunk only, over a row count that is no multiple
    of its 128-row tile."""
    _hold_wide_kernel(100_003, 10, w, 3, head, False, cuda, w)


@pytest.mark.parametrize("head", [True, False])
def test_wide_kernel_64_layers_of_width_32(cuda, head):
    """The narrow trunk whose weights fit in no block (64 layers of width
    32) at 100k rows: the deepest shape the wide kernel takes on a path."""
    route = kernels.trunk_route(10, 32, 64, head, False)
    assert route.bwd == kernels.TRUNK_WIDE
    _hold_wide_kernel(100_003, 10, 32, 64, head, False, cuda, 64)


@pytest.mark.parametrize("d,w,n_layers,bf16", [
    (10, 32, 40, False), (10, 32, 40, True),
    (7, 10, 200, False),   # weight rows that are not 16-byte aligned
])
def test_narrow_forward_with_the_wide_backward(cuda, d, w, n_layers, bf16):
    """Trunks whose forward fits csrc/trunk.cu and whose backward fits no
    narrow kernel, so the two directions run in different kernels and the
    backward's recompute must see the forward's activations. In bf16 the
    plain version's cuBLAS sums straddle a bf16 midpoint in some rows at
    other sizes (2,001 rows: one row at 40 layers, eight at 200), as
    tests/test_torch_fused_mlp.py describes; these inputs have none."""
    route = kernels.trunk_route(d, w, n_layers, True, bf16)
    assert (route.fwd, route.bwd) == (kernels.TRUNK_FWD, kernels.TRUNK_WIDE)
    _hold_trunk(3_001, d, w, n_layers, True, bf16, cuda, n_layers,
                grad_tol=1e-3, val_tol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
def test_wide_trunk_dx_when_asked(cuda, head, bf16):
    """dx from csrc/trunk_wide.cu (dpre_0 W_0^T, in the plain version's
    order of j), d_in past the width, against the plain version's."""
    _hold_trunk(2_000, 100, 48, 4, head, bf16, cuda, 5, dx=True,
                grad_tol=1e-3, val_tol=1e-4)


@pytest.mark.parametrize("d,w", [(10, 33), (64, 64), (10, 128), (128, 128),
                                 (128, 48), (5, 10), (10, 32)])
def test_wide_smem_matches_the_kernel(cuda, d, w):
    """kernels.trunk_wide_smem is csrc/trunk_wide.cu's sum."""
    for bwd in (False, True):
        assert kernels.trunk_wide_smem(d, w, bwd) == \
            library().ct_trunk_wide_smem(d, w, int(bwd))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
def test_wide_forward_is_trunk_cu_bit_for_bit(cuda, head, bf16):
    """At a shape both take (width 32 over d_in 32, 20 layers), the wide
    forward equals csrc/trunk.cu's bit for bit: both sum each output in
    K1-fwd's order."""
    x, layers, out, _, _, _ = _trunk(100_003, 32, 32, 20, cuda, 32)
    w, b = (t.detach() for t in pack_params(layers, out if head else None,
                                            32))
    with torch.no_grad():
        narrow = kernels.trunk_fwd(x, w, b, 32, 20, 0.01, head=head,
                                   bf16=bf16)
        wide = kernels.trunk_wide_fwd(x, w, b, 32, 20, 0.01, head=head,
                                      bf16=bf16)
    for a, c in zip(narrow if head else (narrow,), wide if head else (wide,)):
        assert torch.equal(a, c)


def _narrow_and_wide(n, d, w, n_layers, head, bf16, device, seed,
                     out_w=None):
    """csrc/trunk.cu's forward at kernel width w and csrc/trunk_wide.cu's
    on the same trunk packed at 16 or 32 (zero-padded products add exact
    zeros, so both sum each output in K1-fwd's order), trunk only with
    out_w columns of the model's width out_w (< w), and the plain
    version's outputs; returns (narrow, wide, plain), each a tuple."""
    model_w = out_w or w
    x, layers, out, _, _, _ = _trunk(n, d, model_w, n_layers, device, seed)
    out = out if head else None
    pw = 16 if w <= 16 else 32
    narrow_p, wide_p = ((t.detach() for t in pack_params(layers, out, kw))
                        for kw in (w, pw))
    cfg = dict(head=head, bf16=bf16) if head else dict(
        head=False, bf16=bf16, out_w=model_w)
    with torch.no_grad():
        narrow = kernels.trunk_fwd(x, *narrow_p, w, n_layers, 0.01, **cfg)
        wide = kernels.trunk_wide_fwd(x, *wide_p, pw, n_layers, 0.01, **cfg)
        plain = (plain_trunk_head(x, layers, out, 0.01, bf16=bf16) if head
                 else (plain_trunk(x, layers, 0.01, bf16=bf16),))
    if not head:
        narrow, wide = (narrow,), (wide,)
    return narrow, wide, plain


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("w", kernels.TRUNK_WIDTHS)
def test_narrow_forward_is_the_wide_forward_bit_for_bit(cuda, w, head, bf16):
    """csrc/trunk.cu's forward at every instantiated width (each its own
    rows a thread) equals csrc/trunk_wide.cu's bit for bit, over 2,001
    rows (no multiple of a tile) and d_in 10 (one stage of x); trunk only
    with out_w below the kernel width (a model padded up to it)."""
    out_w = None if head else max(w - 1, 1)
    narrow, wide, _ = _narrow_and_wide(2_001, 10, w, 3, head, bf16, cuda, w,
                                       out_w=out_w)
    for a, c in zip(narrow, wide):
        assert a.shape == c.shape and torch.equal(a, c)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("n,d,w,n_layers", [
    (1, 10, 10, 20),          # one row
    (77, 10, 10, 20),         # below one tile of 128 rows
    (100_003, 10, 10, 20),    # the main path, ragged
    (5_001, 37, 10, 4),       # rows of x past a 128-byte line
    (5_001, 128, 20, 3),      # 2 rows a thread
    (3_001, 10, 32, 55),      # weights of ~225 KB: one block a SM
])
def test_narrow_forward_ragged_rows(cuda, n, d, w, n_layers, head, bf16):
    """The narrow forward over ragged and tiny row counts, wide rows of x
    and a block of the most weights, bit for bit the wide forward; in f32
    also against plain within 1e-5 of the output scale (1e-4 past 20
    layers: sums in another order than cuBLAS's). bf16 against plain is
    held on inputs free of bf16 rounding straddles by
    test_trunk_variants_match_plain."""
    narrow, wide, plain = _narrow_and_wide(n, d, w, n_layers, head, bf16,
                                           cuda, n + d)
    scale = max(max(y.abs().max().item() for y in plain), 1.0)
    tol = 1e-5 if n_layers <= 20 else 1e-4
    for a, c, p in zip(narrow, wide, plain):
        assert torch.equal(a, c)
        assert bf16 or (a - p).abs().max().item() <= tol * scale


def test_trunk_fwd_launch_arithmetic_matches_the_kernel(cuda):
    """kernels.trunk_fwd_rows and the forward's warps a block and a SM,
    from which kernels.trunk_fwd_blocks picks the grid, are csrc/trunk.cu's
    own."""
    import ctypes
    lib = library()
    assert all(kernels.trunk_fwd_rows(k) == lib.ct_trunk_fwd_rows(k)
               for k in kernels.TRUNK_WIDTHS)
    warps, per_sm = ctypes.c_int(), ctypes.c_int()
    lib.ct_trunk_fwd_limits(ctypes.byref(warps), ctypes.byref(per_sm))
    assert (warps.value, per_sm.value) == (kernels.TRUNK_FWD_WARPS,
                                           kernels.TRUNK_FWD_WARPS_PER_SM)


@pytest.mark.parametrize("n_layers", [0, 1])
def test_mlp_without_the_kernel_on_the_card(cuda, n_layers):
    """--mlp-layers 0 and 1 run on the card with plain products and no
    trunk kernel, as on the CPU."""
    from careless_tpu_torch.models.base import Inputs
    from careless_tpu_torch.models.scaling.nn import MLPScaler
    rng = np.random.default_rng(n_layers)
    arrays = (rng.integers(0, 50, 4_000), rng.integers(0, 5, 4_000),
              np.zeros(4_000), rng.normal(size=(4_000, 6)),
              rng.gamma(2.0, 1.0, 4_000), np.ones(4_000))
    m = MLPScaler(n_layers, 6, scale_bijector="exp")
    outs = []
    for device in ("cpu", cuda):
        params = m.init(6, device)
        leaves = [t.requires_grad_(True) for part in params["layers"]
                  + [params["out"]] for t in part.values()]
        kernels.reset_launches()
        q = m.apply(params, Inputs.from_arrays(*arrays, device=device))
        g = torch.autograd.grad((q.loc + q.scale).sum(), leaves)
        outs.append((q.loc.cpu(), [t.cpu() for t in g]))
        assert not any(kernels.LAUNCHES.values())
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[1][1], outs[0][1]):
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


@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("w", [1, 4, 10, 13, 16, 20, 32])
@pytest.mark.parametrize("n", [1, 63, 100_003])
def test_f32_backward_kernel_matches_plain(cuda, n, w, head, dx):
    """The f32 K1-bwd (csrc/trunk_bwd.cu) at ragged N (one row, less than
    a tile, many tiles with a ragged last one), at widths that fill whole
    quads and widths that do not, with the head and without, with and
    without dx. Gradients within chip_smoke.trunk_rows' 1e-4 of each
    one's largest entry: at width 1 a weight's gradient is one sum over
    all N rows, and at N = 100,003 it cancels to ~14 from terms of order
    1, where f32 rounding alone parts two summation orders by 2e-5 of it
    (the kernel's per-tile order against cuBLAS's)."""
    d = 7
    assert kernels.trunk_bwd_route(d, kernels.trunk_width(w), 4, head,
                                   False)[0] == kernels.TRUNK_BWD_F32
    _hold_trunk(n, d, w, 4, head, False, cuda, n + w, dx=dx, grad_tol=1e-4)


@pytest.mark.parametrize("d,w,n_layers", [(10, 10, 20), (28, 28, 20),
                                          (5, 8, 3), (128, 32, 3),
                                          (7, 1, 1)])
@pytest.mark.parametrize("head", [True, False])
def test_f32_backward_smem_matches_the_kernel(cuda, d, w, n_layers, head):
    """kernels.trunk_bwd_f32_smem, which picks the f32 kernel's tile and
    the route, is csrc/trunk_bwd.cu's sum."""
    for tile in kernels.TRUNK_BWD_F32_TILES + (96,):
        assert kernels.trunk_bwd_f32_smem(d, w, n_layers, head, tile) == \
            library().ct_trunk_bwd_f32_smem(d, w, n_layers, int(head), tile)


@pytest.mark.parametrize("d,w,n_layers,head", [(32, 32, 20, True),
                                               (128, 32, 20, False)])
def test_f32_shapes_past_the_f32_kernel_run_the_general_one(cuda, d, w,
                                                            n_layers, head):
    """An f32 shape whose shared memory fits no tile of csrc/trunk_bwd.cu
    runs csrc/trunk.cu's backward, under the same launch name, against the
    plain version."""
    kernel, tile = kernels.trunk_bwd_route(d, w, n_layers, head, False)
    assert kernel == kernels.TRUNK_BWD_GENERAL and tile <= 16
    _hold_trunk(1_001, d, w, n_layers, head, False, cuda, n_layers)


def _bf16_terms_summed_in_f64(x, layers, out, cts, leak=0.01):
    """The bf16 plain version's gradients, from its own f32 forward and
    dpre chain (the operations of plain_trunk and _BF16Matmul, so the same
    values and the same bf16 roundings), with each weight's and bias's sum
    over the rows taken in f64: the exact sum of the plain version's terms.
    Its own f32 sums over 100k rows part from that by more than 1e-4 of a
    gradient that cancels (at width 1, a 1 x 1 weight summing to ~0.07
    from terms of order 1)."""
    with torch.no_grad():
        hs, pres, h = [x], [], x
        for layer in layers:
            pre = round_bf16(h) @ round_bf16(layer["w"]) + layer["b"]
            h = torch.where(pre >= 0, pre, leak * pre)
            pres.append(pre)
            hs.append(h)
        grads = []
        if out is not None:
            dp = torch.stack(cts, 1)
            grads = [round_bf16(h).double().T @ round_bf16(dp).double(),
                     dp.double().sum(0)]
            dh = round_bf16(dp) @ round_bf16(out["w"]).T
        else:
            dh = cts[0]
        for i in reversed(range(len(layers))):
            dp = torch.where(pres[i] >= 0, dh, leak * dh)
            grads = [round_bf16(hs[i]).double().T @ round_bf16(dp).double(),
                     dp.double().sum(0)] + grads
            if i:
                dh = round_bf16(dp) @ round_bf16(layers[i]["w"]).T
        return grads


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("n,d,w,n_layers", [
    (1_000_000, 10, 10, 20),  # the bf16 slices' shape
    (100_003, 10, 10, 20),    # a ragged last tile
    (100_003, 7, 1, 4),
    (100_003, 7, 16, 4),
    (100_003, 28, 28, 20),    # width pads to 32
    (100_003, 128, 32, 20),   # d_in 128: one warp a block
    (63, 3, 4, 1),            # less than one tile, one layer
])
def test_bf16_backward_kernel_matches_plain(cuda, n, d, w, n_layers, head):
    """The bf16 K1-bwd (csrc/trunk_bwd_bf16.cu) against the bf16 plain
    version's terms summed exactly (_bf16_terms_summed_in_f64), within
    chip_smoke.trunk_rows' 1e-4 of each gradient's largest entry, and bit
    for bit against itself."""
    assert kernels.trunk_bwd_route(d, kernels.trunk_width(w), n_layers,
                                   head, True)[0] == kernels.TRUNK_BWD_BF16
    x, layers, out, leaves, gl, gr = _trunk(n, d, w, n_layers, cuda, n + w)
    if head:
        fn, cts = fused_mlp_trunk_head, (gl, gr)
    else:
        fn = fused_mlp_trunk
        cts = (torch.randn(n, w, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(n)),)
        out, leaves = None, leaves[:-2]
    kernels.reset_launches()
    _, g_k = _run_trunk(fn, x, layers, out, cts, leaves, True)
    _, g_k2 = _run_trunk(fn, x, layers, out, cts, leaves, True)
    assert kernels.LAUNCHES[kernels.trunk_key("bwd", head, True)] == 2
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
    want = _bf16_terms_summed_in_f64(x, layers, out, cts)
    for a, b in zip(g_k, want):
        assert (a.double() - b).abs().max().item() \
            <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("head", [True, False])
def test_bf16_backward_kernel_dx_when_asked(cuda, head):
    """dx from the bf16 K1-bwd (bf16(dpre_0) bf16(W_0)^T, in the plain
    version's order of j) against the plain version's, per row."""
    x, layers, out, _, gl, gr = _trunk(2_000, 6, 8, 4, cuda, 3)
    cts = ((gl, gr) if head else
           (torch.randn(2_000, 8, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(3)),))
    grads = []
    for fn in ((fused_mlp_trunk_head, plain_trunk_head) if head
               else (fused_mlp_trunk, plain_trunk)):
        xr = x.clone().requires_grad_(True)
        ys = (fn(xr, layers, out, 0.01, bf16=True) if head
              else (fn(xr, layers, 0.01, bf16=True),))
        (g,) = torch.autograd.grad(
            sum((y * c).sum() for y, c in zip(ys, cts)), xr)
        grads.append(g)
    assert kernels.trunk_bwd_route(6, 8, 4, head, True)[0] \
        == kernels.TRUNK_BWD_BF16
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,w,n_layers", [(10, 10, 20), (28, 28, 20),
                                          (5, 8, 3), (128, 32, 20),
                                          (7, 1, 1)])
@pytest.mark.parametrize("head", [True, False])
def test_bf16_backward_smem_matches_the_kernel(cuda, d, w, n_layers, head):
    """kernels.trunk_bwd_bf16_smem, which picks the bf16 kernel's block and
    the route, is csrc/trunk_bwd_bf16.cu's sum."""
    for tile in kernels.TRUNK_BWD_F32_TILES + (96,):
        assert kernels.trunk_bwd_bf16_smem(d, w, n_layers, head, tile) == \
            library().ct_trunk_bwd_bf16_smem(d, w, n_layers, int(head), tile)


@pytest.mark.parametrize("n", [1, 2, 5, 4_099, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 1001, 2 ** 33 + 3])
def test_philox_kernel_at_unaligned_offsets(cuda, n, offset):
    """K3 writes the elements of a range that starts or ends inside a
    Philox block (scalar stores for its head and tail): words bit for bit
    and normals within 2e-5 of the plain version."""
    got, bits = kernels.philox_normal(n, 0xDEADBEEF12345678, offset, cuda,
                                      with_bits=True)
    want, bits_p = plain_prng_normal(n, 0xDEADBEEF12345678, offset, cuda,
                                     with_bits=True)
    assert torch.equal(bits, bits_p)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1_000_000, 1_000_003])
@pytest.mark.parametrize("sm_count", [1, 132, None])
def test_fused_ll_parts_match_the_kernel(cuda, n, sm_count):
    """kernels.fused_ll_parts and fused_ll_bwd_parts, which size K4's grid
    and partial sums, are csrc/fused_ll.cu's counts (at least one), on a
    card of 1 or 132 SMs and on this one."""
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(
            cuda).multi_processor_count
    assert kernels.fused_ll_parts(n, sm_count) == \
        library().ct_fused_ll_parts(n, sm_count)
    assert kernels.fused_ll_bwd_parts(n) == library().ct_fused_ll_bwd_parts(n)


@pytest.mark.parametrize("with_bits", [False, True])
@pytest.mark.parametrize("index", [None, 0])
def test_philox_launcher_on_the_current_device(cuda, with_bits, index):
    """K3 through its trimmed launcher, with the device named by type alone
    or by index: words bit for bit and normals within 2e-5 of the plain
    version; one launch per call."""
    n, seed, offset = 300_007, 0x0FEDCBA987654321, 2 ** 33 + 5
    kernels.reset_launches()
    got = kernels.philox_normal(n, seed, offset, torch.device("cuda", index),
                                with_bits=with_bits)
    assert kernels.LAUNCHES["philox_normal"] == 1
    want = plain_prng_normal(n, seed, offset, cuda, with_bits=True)
    if with_bits:
        assert torch.equal(got[1], want[1])
        got = got[0]
    torch.testing.assert_close(got, want[0], rtol=0, atol=2e-5)


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
    assert kernels.LAUNCHES == {k: int(k == "gather")
                                for k in kernels.LAUNCHES}
    # 13 names, and csrc/trunk_wide.cu's eight instantiations
    assert len(kernels.LAUNCHES) == 21


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


@pytest.mark.parametrize("kind,dof", K4_KINDS)
@pytest.mark.parametrize("n", [1, 3, 255, 1_000_003])
def test_fused_ll_fwd_ragged(cuda, kind, dof, n):
    """K4-fwd at offsets 0, 1, 2, 3 and n (ragged head and tail quads, and
    16-byte loads only where offset and every address are aligned: the
    inputs also as views one element in), with a mask, with supplied noise
    and with its own Philox: the sum at rtol 1e-5 of plain's and within
    1e-5 of the sum of |mask ll| (f32 sums in another order), its own eps
    bitwise K3's (fed in, the same sum bit for bit), and each call bit for
    bit repeatable."""
    seed = 0x5EED | (11 << 32)
    ins, mask, ev, noise = _k4_inputs(n + 1, cuda, 9)
    whole = list(ins.values()) + [mask, noise]
    t_const = studentt_log_norm(dof) if dof else 0.0
    for start in (0, 1):
        args = [x[start:start + n] for x in whole]
        loc, scale, a, f, iobs, sig, m, nz = args
        for offset in (0, 1, 2, 3, n):
            cfg = dict(kind=kind, dof=dof, seed=seed, offset=offset,
                       t_const=t_const)
            k3 = kernels.philox_normal(n, seed, offset, cuda)
            for supplied in (nz, None):
                eps = supplied if supplied is not None else \
                    plain_prng_normal(n, seed, offset, cuda)
                out = kernels.fused_ll_fwd(loc, scale, a, f, iobs, sig, m,
                                           supplied, ev, **cfg)
                want = plain_fused_likelihood_sum(loc, scale, a, f, iobs,
                                                  sig, m, ev, eps, kind=kind,
                                                  dof=dof)
                ipred = (a * loc + a.abs() * scale * eps) * f * f
                l1 = (m * pointwise_ll(kind, dof, ev, iobs, sig, ipred)
                      ).abs().sum().item()
                assert abs(out.item() - want.item()) <= 1e-5 * l1, \
                    (start, offset, supplied is None)
                assert torch.equal(out, kernels.fused_ll_fwd(
                    loc, scale, a, f, iobs, sig, m, supplied, ev, **cfg))
            assert torch.equal(
                kernels.fused_ll_fwd(loc, scale, a, f, iobs, sig, m, None,
                                     ev, **cfg),
                kernels.fused_ll_fwd(loc, scale, a, f, iobs, sig, m, k3, ev,
                                     **cfg)), (start, offset)


def test_fused_ll_tickets_return_to_zero(cuda):
    """After launches of both directions at every kind, with and without
    the Ev11 sums, at grids of 1 to ~3,900 blocks, the two device tickets
    of csrc/fused_ll.cu's last-block sums read 0, ready for the next."""
    import ctypes
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ct = torch.tensor(0.5, device=cuda)
    for n in (1, 300, 1_000_000):
        ins, _, ev, _ = _k4_inputs(n, cuda, 12)
        for kind, dof in K4_KINDS:
            cfg = dict(kind=kind, dof=dof, seed=5, offset=n,
                       t_const=studentt_log_norm(dof) if dof else 0.0)
            kernels.fused_ll_fwd(*ins.values(), None, None, ev, **cfg)
            kernels.fused_ll_bwd(*ins.values(), None, None, ev, ct, **cfg)
        assert kernels.fused_ll_parts(n, sms) >= 1
    tickets = (ctypes.c_uint32 * 2)()
    assert library().ct_fused_ll_tickets(tickets) == 0
    assert list(tickets) == [0, 0]


def test_fused_ll_fwd_is_one_launch_of_any_grid(cuda):
    """K4-fwd writes its sum in one launch whatever its grid (the last
    block's ticket wraps back to 0 for the next launch): through the C
    entry point at 1, 2, 7 and the launcher's blocks, each call within
    1e-5 of plain's sum and bit for bit repeatable."""
    n, seed, offset = 100_001, 0x77 | (5 << 32), 2
    ins, mask, ev, _ = _k4_inputs(n, cuda, 10)
    args = list(ins.values())
    want = plain_fused_likelihood_sum(
        *args, mask, ev, plain_prng_normal(n, seed, offset, cuda),
        kind="normal", dof=0.0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for parts in (1, 2, 7, kernels.fused_ll_parts(n, sms)):
        sums = []
        for _ in range(2):
            part = torch.empty(parts, device=cuda)
            out = torch.empty((), device=cuda)
            err = library().ct_fused_ll_fwd(
                *(x.data_ptr() for x in args), mask.data_ptr(), None,
                ev.data_ptr(), part.data_ptr(), out.data_ptr(), n, parts, 0,
                0.0, 0.0, seed & 0xFFFFFFFF, seed >> 32, offset,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0
            sums.append(out.clone())
        torch.testing.assert_close(sums[0], want, rtol=1e-5, atol=0)
        assert torch.equal(sums[0], sums[1])


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
    swap case; an unaligned table (a view one entry in) is staged by the
    kernel at its own alignment, with no copy on the host."""
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


@pytest.mark.parametrize("n", [1, 3, 5, 4_003, 2_000_000])
def test_gather_kernel_ragged_and_random_permutation(cuda, n):
    """K2 bit for bit against its plain version and index_select: at
    lengths that leave a ragged tail of 1 to 3 entries past the kernel's
    4-entry groups, and at a random permutation of 2M entries, whose table
    is the size of the ids (the Laue image cotangent's permute)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn(max(n, 1000), generator=gen, device=cuda)
    ids = (torch.randperm(n, generator=gen, device=cuda) if n > 1000 else
           torch.randint(0, 1000, (n,), generator=gen, device=cuda)
           ).to(torch.int32)
    kernels.reset_launches()
    got = table_gather(table, ids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather"] == 1
    assert torch.equal(got, plain_gather(table, ids))
    assert torch.equal(got, torch.index_select(table, 0, ids))


def _hold_stream(table, ids2d, bases, window, block_rows):
    """K5 against its plain version and, where an id lies inside its tile's
    window and the table, against index_select (zero elsewhere)."""
    kernels.reset_launches()
    got = windowed_gather_stream(table, ids2d, bases, window, block_rows)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_stream"] == 1
    assert torch.equal(got, plain_windowed_gather(table, ids2d, bases,
                                                  window, block_rows))
    ids = ids2d.reshape(bases.shape[0], -1).long()
    off = ids - 128 * bases.long()[:, None]
    inside = ((off >= 0) & (off < 128 * window) & (ids < table.shape[0])
              ).reshape(-1)
    flat = ids.reshape(-1)
    want = torch.where(inside, torch.index_select(
        table, 0, torch.where(inside, flat, 0)), 0.0)
    assert torch.equal(got, want)
    return got, inside


@pytest.mark.parametrize("t", [300_001, 1_027])
def test_gather_stream_window_past_the_table_end(cuda, t):
    """Windows that run past the table's end, at a length that is a
    multiple of neither 4 nor 128: the part past the end reads 0 and the
    ragged last entries come through."""
    rng = np.random.default_rng(t)
    window, block_rows = 12, 16
    rows = -(-t // 128)
    bases = np.array([0, max(rows - window, 0), rows - 1, rows - 3])
    lo = np.repeat(bases * 128, block_rows * 128)
    ids = lo + rng.integers(0, window * 128, lo.shape)
    table = torch.tensor(rng.normal(size=t).astype(np.float32), device=cuda)
    ids2d = torch.tensor(ids.reshape(-1, 128).astype(np.int32), device=cuda)
    got, inside = _hold_stream(table, ids2d, torch.tensor(
        bases.astype(np.int32), device=cuda), window, block_rows)
    assert (~inside).any() and (got[~inside] == 0).all()
    assert (ids == t - 1).any()


@pytest.mark.parametrize("window", [1, 160])
def test_gather_stream_window_1_and_the_cap(cuda, window):
    """K5 at a one-row window and at the plans' 160-row cap (80 KB of
    shared memory, two blocks to an SM), ids on either side of each
    window."""
    rng = np.random.default_rng(window)
    n_tiles, t = 9, 400_000
    bases = rng.integers(0, t // 128 - window, n_tiles)
    lo = np.repeat(bases * 128, 64 * 128)
    ids = np.clip(lo + rng.integers(-200, window * 128 + 200, lo.shape), 0,
                  t - 1)
    table = torch.tensor(rng.normal(size=t).astype(np.float32), device=cuda)
    _, inside = _hold_stream(
        table, torch.tensor(ids.reshape(-1, 128).astype(np.int32),
                            device=cuda),
        torch.tensor(bases.astype(np.int32), device=cuda), window, 64)
    assert inside.any() and (~inside).any()


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_gather_stream_misaligned_table(cuda, shift):
    """A table that starts 4, 8 or 12 bytes past a 16-byte boundary: the
    kernel stages each window at the table's own alignment (bulk copy of
    the aligned middle, the edges by threads); no host-side copy."""
    rng = np.random.default_rng(shift)
    t = 70_000
    buf = torch.tensor(rng.normal(size=t + shift).astype(np.float32),
                       device=cuda)
    table = buf[shift:]
    assert table.data_ptr() % 16 == 4 * shift
    # quasi-identity: shuffled within runs of 1,000
    perm = np.concatenate([rng.permutation(np.arange(s, min(s + 1000, t)))
                           for s in range(0, t, 1000)])
    ids2d, bases, window = _plan_windows(perm.astype(np.int32), t,
                                         max_chunks=160, max_rows=1 << 20)
    assert window > 0
    _hold_stream(table, torch.tensor(ids2d, device=cuda),
                 torch.tensor(bases, device=cuda), window, 64)


def test_gather_stream_smem_matches_the_kernel(cuda):
    """kernels.stream_smem, which the launcher checks, is csrc/
    gather_stream.cu's sum."""
    for window in (1, 5, 66, 160, 453):
        assert kernels.stream_smem(window) == \
            library().ct_gather_stream_smem(window)


def test_gather_launchers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card the launchers still check type, device and contiguity:
    int64 ids, an f64 table, a CPU tensor and a strided view raise."""
    table = torch.zeros(1000, device=cuda)
    ids = torch.zeros(256, dtype=torch.int32, device=cuda)
    bases = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in ((table, ids.long()), (table.double(), ids), (table.cpu(), ids),
                (table, ids.cpu()), (table[::2], ids), (table, ids[::2])):
        with pytest.raises(ValueError, match="contiguous"):
            kernels.gather(*bad)
    for bad in ((table, ids.long().reshape(2, 128), bases),
                (table.double(), ids.reshape(2, 128), bases),
                (table, ids.reshape(2, 128), bases.long()),
                (table, ids.reshape(2, 128).cpu(), bases),
                (table[::2], ids.reshape(2, 128), bases)):
        with pytest.raises(ValueError, match="contiguous"):
            kernels.gather_stream(*bad, 2, 1)


@pytest.mark.parametrize("kind", ["studentt", "studentt_ev11"])
def test_fused_ll_studentt_within_ipred_rounding(cuda, kind):
    """K4-bwd's Student-t gradients at chip_smoke's input recipe and the
    seed STUDENTT_TEST_SEED, where they differ from the plain version by
    more than 1e-5 of each tensor's largest entry. That is rounding: the
    kernel fuses ipred = (a loc + |a| scale eps) f^2 into multiply-adds
    where the plain version rounds each step, and a Student-t d ll / d
    ipred is steep near r = 0 (-(dof + 1) / (dof s^2), -125 at s = 0.1)
    while 1e-5 of its largest entry is small (chip_smoke.studentt_check).
    Held per observation within |ct| |dg/dipred| (IPRED_ULPS ulps of
    ipred's terms) |multiplier| + 1e-5 of the largest entry, and the
    kernel no farther from the f64 gradient than the plain version is,
    plus that bound; with supplied noise and with the kernel's normals."""
    import chip_smoke
    n, key, offset = 1_000_000, 0x0FEDCBA987654321, 1_000_000
    gen = torch.Generator(device=cuda).manual_seed(
        chip_smoke.STUDENTT_TEST_SEED)
    args = chip_smoke.k4_inputs(torch, gen, n, cuda)
    noise = torch.randn(n, generator=gen, device=cuda)
    ev = torch.tensor([1.3, 0.2, 0.7], device=cuda)
    ct = torch.tensor(0.75, device=cuda)
    cfg = dict(kind=kind, dof=4.0, seed=key, offset=offset,
               t_const=studentt_log_norm(4.0))
    eps_k = kernels.philox_normal(n, key, offset, cuda)
    for supplied in (noise, None):
        eps = noise if supplied is not None else plain_prng_normal(
            n, key, offset, cuda)
        got = kernels.fused_ll_bwd(*args, None, supplied, ev, ct, **cfg)
        ref = plain_fused_likelihood_grads(*args, None, ev, eps, ct,
                                           kind=kind, dof=4.0)
        ratios = chip_smoke.studentt_check(
            torch, args, ev, eps, None if supplied is not None else eps_k,
            ct, kind, 4.0, got[:4], ref[:4], "card test")
        assert ratios["new"] <= 1.0 and ratios["f64"] <= 1.0


def test_gather_stream_refuses_a_window_past_shared_memory(cuda):
    window = kernels.MAX_SMEM_PER_BLOCK // 512 + 1
    with pytest.raises(ValueError, match="shared memory"):
        kernels.gather_stream(torch.zeros(1000, device=cuda),
                              torch.zeros((64, 128), dtype=torch.int32,
                                          device=cuda),
                              torch.zeros(1, dtype=torch.int32, device=cuda),
                              window, 64)


def _halves_on(device, laue, seed=3, clip=None, **flags):
    """A 2-repeat half split (K = 4) of build_problem's data on `device`,
    the manager and the frozen-scaler trainer of the CLI defaults with
    --global-clipnorm `clip` and `flags`, 2 layers."""
    import dataclasses
    import types

    import chip_smoke
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.models.base import Inputs

    arrays, asu, _ = chip_smoke.build_problem(seed, 20_000, 2_000, 40, 4,
                                              laue=laue)
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed,
                                      "global_clipnorm": clip, **flags})
    dm = DataManager(Inputs.from_arrays(*arrays, device=device), asu, parser,
                     device=device)
    _, params, trainer = dm.build_model()
    trainer = dataclasses.replace(trainer, freeze=("scaler",))
    halves = dm.split_data_by_image() + dm.split_data_by_image()
    return dm, params, trainer, halves


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_xval_parallel_equals_serial_on_the_card(cuda, laue, clip):
    """The parallel form (parallel/xval.py) against each half trained
    alone by Trainer.train, on the card, 3 steps: each half's parameters
    bit for bit (the blocked segment sum keeps each half's sums in its
    serial order), at rtol 1e-5 under --global-clipnorm 0.5 (each half's
    norm sums its leaves in a row of K, so the clip factor may round
    otherwise), and its loss, NLL, KL and Grad Norm history at rtol 1e-5;
    K1-bwd never launched."""
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.parallel.xval import (half_params,
                                                  make_half_keys,
                                                  stack_halves, train_halves)

    dm, params, trainer, halves = _halves_on(cuda, laue, clip=clip)
    seeds = make_half_keys(3, 2)
    kernels.reset_launches()
    serial = [trainer.train(params, seeded_generator(s, cuda),
                            dm.planned_inputs(h).inputs, 3, device=cuda)
              for h, s in zip(halves, seeds)]
    stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                           dm.n_refl, dm.n_images)
    trained, history = train_halves(trainer, params, seeds, stacked, 3,
                                    device=cuda)
    assert kernels.LAUNCHES["trunk_bwd"] == 0
    assert kernels.LAUNCHES["trunk_fwd"] == 4 * 3 + 3
    for k, (p_serial, h_serial) in enumerate(serial):
        got = dict(flatten_params(half_params(trained, k, trainer.freeze)))
        for name, want in flatten_params(p_serial):
            if clip is None:
                assert torch.equal(got[name], want), (k, name)
            else:
                np.testing.assert_allclose(got[name].cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=name)
        for key, values in h_serial.items():
            np.testing.assert_allclose(np.asarray(history[key])[:, k],
                                       values, rtol=1e-5, err_msg=key)


def test_xval_k3_per_half_is_the_serial_noise(cuda, monkeypatch):
    """The parallel form launches K3 once per half a step at offset 0 with
    that half's key, and its normals are the serial half's bit for bit."""
    import careless_tpu_torch.models.merging.variational as variational
    import careless_tpu_torch.parallel.xval as xval
    from careless_tpu_torch.device import seeded_generator

    dm, params, trainer, halves = _halves_on(cuda, False)
    seeds = xval.make_half_keys(3, 2)
    drawn = {"serial": [], "parallel": []}

    def spy(where, real):
        def draw(n, seed, offset, device):
            out = real(n, seed, offset, device)
            drawn[where].append((n, seed, offset, out.clone()))
            return out
        return draw
    monkeypatch.setattr(variational, "prng_normal",
                        spy("serial", variational.prng_normal))
    monkeypatch.setattr(xval, "prng_normal", spy("parallel",
                                                 xval.prng_normal))
    for h, s in zip(halves, seeds):
        trainer.train(params, seeded_generator(s, cuda),
                      dm.planned_inputs(h).inputs, 2, device=cuda)
    stacked = xval.stack_halves([dm.planned_rows(h).inputs for h in halves],
                                dm.n_refl, dm.n_images)
    kernels.reset_launches()
    xval.train_halves(trainer, params, seeds, stacked, 2, device=cuda)
    assert kernels.LAUNCHES["philox_normal"] == 4 * 2
    # serial: half by half, step by step; parallel: step by step, half by half
    serial = [drawn["serial"][2 * k + i] for i in range(2) for k in range(4)]
    assert len(drawn["parallel"]) == len(serial) == 8
    for (n, seed, offset, a), (m, key, at, b) in zip(drawn["parallel"],
                                                     serial):
        assert (n, seed, offset) == (m, key, at) and offset == 0
        assert torch.equal(a, b)


def test_xval_fused_k4_per_half_on_the_card(cuda):
    """--mc-samples=2 --fused-kernel=on with the Student-t likelihood and
    Ev11 (K4's studentt_ev11): the parallel form launches K4 once per
    half and sample each way, with that half's key, and no K3; each half's
    parameters (its Ev11 scalars too) equal its serial run's bit for bit
    after 3 steps, as on the CPU, and its history at rtol 1e-5."""
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.parallel.xval import (half_params,
                                                  make_half_keys,
                                                  stack_halves, train_halves)

    dm, params, trainer, halves = _halves_on(
        cuda, False, mc_samples=2, fused_kernel="on",
        studentt_likelihood_dof=4.0, refine_uncertainties=True)
    assert trainer.model.fused_kernel and trainer.model.mc_samples == 2
    seeds = make_half_keys(3, 2)
    serial = [trainer.train(params, seeded_generator(s, cuda),
                            dm.planned_inputs(h).inputs, 3, device=cuda)
              for h, s in zip(halves, seeds)]
    stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                           dm.n_refl, dm.n_images)
    kernels.reset_launches()
    trained, history = train_halves(trainer, params, seeds, stacked, 3,
                                    device=cuda)
    assert kernels.LAUNCHES["fused_ll_fwd"] == 4 * 2 * 3
    assert kernels.LAUNCHES["fused_ll_bwd"] == 4 * 2 * 3
    assert kernels.LAUNCHES["philox_normal"] == 0
    assert kernels.LAUNCHES["trunk_bwd"] == 0
    for k, (p_serial, h_serial) in enumerate(serial):
        got = dict(flatten_params(half_params(trained, k, trainer.freeze)))
        for name, want in flatten_params(p_serial):
            assert torch.equal(got[name], want), (k, name)
        for key, values in h_serial.items():
            np.testing.assert_allclose(np.asarray(history[key])[:, k],
                                       values, rtol=1e-5, err_msg=key)


def test_data_manager_pickled_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    """`main mono --save-data-manager` on the card writes a pickle of numpy
    arrays: DataManager.from_pickle puts its Inputs on the CPU, equal bit
    for bit to the formatter's there, and by default on the card."""
    import chip_smoke
    from careless_tpu_torch.io.formatter import MonoFormatter
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.main import main
    from careless_tpu_torch.models.base import ROW_FIELDS
    from careless_tpu_torch.parser import parser
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    cell = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, cell,
                                                    "P 63", 3.0)
    mtz, out = str(tmp_path / "in.mtz"), str(tmp_path / "out")
    write_mtz(DataSet(cols, cell=UnitCell(*cell),
                      spacegroup=SpaceGroup.from_name("P 63"),
                      mtz_dtypes=types_), mtz)
    argv = ["mono", "dHKL,image_id,XDET", mtz, out, "--iterations=3",
            "--mlp-layers=2", "--disable-progress-bar",
            "--save-data-manager"]
    main(argv)
    dm = DataManager.from_pickle(out + "_data_manager.pickle", "cpu")
    args = parser.parse_args(argv)
    inputs, _ = MonoFormatter.from_parser(args).format_files(
        args.reflection_files, device="cpu")
    for f in ROW_FIELDS:
        a, b = getattr(dm.inputs, f), getattr(inputs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.device.type == "cpu" and torch.equal(a, b), f
    on_card = DataManager.from_pickle(out + "_data_manager.pickle")
    assert on_card.device.type == "cuda"
    assert on_card.inputs.refl_id.device.type == "cuda"
    assert torch.equal(on_card.inputs.metadata.cpu(), inputs.metadata)


def test_to_intensities_on_the_card_equals_the_cpu(cuda, tmp_path):
    """to_intensities' SigI (the truncated-normal moments) on the card
    within rtol 1e-5 of the same call on the CPU, I bit for bit, plain and
    --anomalous, from a 3-step merge's posterior columns."""
    import chip_smoke
    from careless_tpu_torch.main import main
    from careless_tpu_torch.scripts import to_intensities
    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         write_mtz)

    cell = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, cell,
                                                    "P 63", 3.0)
    mtz = str(tmp_path / "in.mtz")
    write_mtz(DataSet(cols, cell=UnitCell(*cell),
                      spacegroup=SpaceGroup.from_name("P 63"),
                      mtz_dtypes=types_), mtz)
    for flags in ([], ["--anomalous"]):
        out = str(tmp_path / f"out{len(flags)}")
        main(["mono", "dHKL,image_id,XDET", mtz, out, "--iterations=3",
              "--mlp-layers=2", "--disable-progress-bar", *flags])
        args = to_intensities.ArgumentParser().parse_args(
            flags + [out + "_0.mtz", str(tmp_path / "i.mtz")])
        card = to_intensities.run(args)
        cpu = to_intensities.run(args, device="cpu")
        assert card.columns == cpu.columns
        for c in card.columns:
            if c.startswith("SigI"):
                ok = ~np.isnan(cpu[c])
                assert np.array_equal(np.isnan(card[c]), ~ok), c
                np.testing.assert_allclose(card[c][ok], cpu[c][ok],
                                           rtol=1e-5, err_msg=c)
            else:
                np.testing.assert_array_equal(card[c], cpu[c], err_msg=c)


@pytest.mark.parametrize("row0,n,n_all,samples", [
    (0, 100_003, 300_001, (0, 1)), (100_003, 100_001, 300_001, (0, 1)),
    (200_004, 99_997, 300_001, (1, 3)), (0, 300_001, 300_001, (1, 2))])
def test_shard_noise_on_the_card_is_the_unsharded_slice(cuda, row0, n, n_all,
                                                        samples):
    """A shard's scale noise (rows row0 .. row0 + n of n_all, its samples),
    at offsets s n_all + row0 that are mostly not multiples of 4: K3's draw
    for the shard is the unsharded draw's slice bit for bit, and K4's own
    draw there equals K4 fed that slice, both ways, bit for bit."""
    from careless_tpu_torch.models.merging.variational import \
        VariationalMergingModel

    seed = 0x0FEDCBA987654321
    full = kernels.philox_normal(3 * n_all, seed, 0, cuda).view(3, n_all)
    got = VariationalMergingModel._scale_noise(seed, range(*samples), row0,
                                               n, n_all, cuda)
    assert torch.equal(got, full[samples[0]:samples[1], row0:row0 + n])
    ins, _, ev, _ = _k4_inputs(n, cuda, 5)
    args = list(ins.values())
    ct = torch.tensor(1.0, device=cuda)
    for j, s in enumerate(range(*samples)):
        cfg = dict(kind="normal", dof=0.0, t_const=0.0, seed=seed,
                   offset=s * n_all + row0)
        assert torch.equal(kernels.fused_ll_fwd(*args, None, None, ev, **cfg),
                           kernels.fused_ll_fwd(*args, None, got[j], ev,
                                                **cfg))
        own = kernels.fused_ll_bwd(*args, None, None, ev, ct, **cfg)
        fed = kernels.fused_ll_bwd(*args, None, got[j], ev, ct, **cfg)
        assert all(a is b or torch.equal(a, b) for a, b in zip(own, fed))


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_nccl_world_one_is_the_unsharded_run(cuda, tmp_path, laue):
    """A sharded run at world size 1 over NCCL (one rank holding every row)
    gives the unsharded run's history and parameters bit for bit."""
    import torch.distributed as dist

    import chip_smoke
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.merging.variational import flatten_params
    from careless_tpu_torch.parallel import distributed
    from careless_tpu_torch.parallel.shard import shard_inputs

    model, params, trainer, layout, f_true = chip_smoke.model_on(
        cuda, 0, 20_000, 500, 40, 6, 4, laue=laue, plans=False)
    n_refl, n_images = len(f_true), 40
    ref = trainer.train(params, seeded_generator(0, cuda),
                        layout.with_plans(n_refl, n_images), 4, chunk_size=2,
                        device=cuda)
    distributed.initialize("nccl", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        assert dist.get_backend() == "nccl"
        inputs, shard = shard_inputs(layout, 0, 1, n_refl, n_images)
        one = trainer.train(params, seeded_generator(0, cuda), inputs, 4,
                            chunk_size=2, device=cuda, shard=shard)
    finally:
        dist.destroy_process_group()
    assert one[1] == ref[1]
    for (name, a), (_, b) in zip(flatten_params(one[0]),
                                 flatten_params(ref[0])):
        assert torch.equal(a, b), name
