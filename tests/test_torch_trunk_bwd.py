"""K1's kernels: which one a shape takes in each direction, and at which
tile.

csrc/trunk_bwd.cu runs the f32 backward (head or trunk only),
csrc/trunk_bwd_bf16.cu the bf16 one on tensor cores, and csrc/trunk.cu's
backward the shapes whose shared memory fits not even one warp of the
other two; csrc/trunk.cu runs the forward where its weights fit in a
block. csrc/trunk_wide.cu takes both directions of every other shape up
to max(d_in, width) = 128 (kernels.trunk_route). All are CUDA only; what
the CPU can check is the Python side that chooses between them:
kernels.trunk_bwd_f32_smem, kernels.trunk_bwd_bf16_smem and
kernels.trunk_wide_smem (copies of the kernels' own sums, held equal to
them by card tests), the tile each kernel takes, and the routes. The
launchers refuse CPU tensors here, so nothing reaches a kernel. The kernels' arithmetic is
held against the JAX package through their plain versions in
tests/test_torch_fused_mlp.py and on the card in tests/test_torch_cuda.py.
"""
import pytest
import torch

from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_mlp import pack_params

F32, GENERAL = kernels.TRUNK_BWD_F32, kernels.TRUNK_BWD_GENERAL
BF16, WIDE = kernels.TRUNK_BWD_BF16, kernels.TRUNK_WIDE


@pytest.mark.parametrize("d,w,n_layers,head,tile,floats", [
    # the weights and biases flat (rounded up to a quad), shared; then per
    # warp 16 floats for each 4x4 item of dW (3 x 3 items a layer at width
    # 10, 3 x 1 for the head), a quad of db per 4 columns and layer, and the
    # 32-row stash: x at 12 floats, 20 activation rows at 12, the head's
    # quad
    (10, 10, 20, True, 128,
     2224 + 4 * (16 * (9 + 19 * 9 + 3) + 4 * (20 * 3 + 1)
                 + 32 * (12 + 20 * 12 + 4))),
    (10, 10, 20, False, 64,
     2200 + 2 * (16 * (9 + 19 * 9) + 4 * 20 * 3 + 32 * (12 + 20 * 12))),
    # width 8 pads its stash rows to 12 floats (3 quads, an odd number);
    # d_in 5 pads to 12 as well; 210 parameters round up to 212
    (5, 8, 3, True, 32,
     212 + 16 * (2 * 2 + 2 * 4 + 2) + 4 * (3 * 2 + 1)
     + 32 * (12 + 3 * 12 + 4)),
    # width 32 and d_in 128: stash rows of 36 and 132 floats
    (128, 32, 20, False, 32,
     (128 * 32 + 19 * 1024 + 640) + 16 * (32 * 8 + 19 * 64) + 4 * 20 * 8
     + 32 * (132 + 20 * 36)),
])
def test_f32_smem_sum(d, w, n_layers, head, tile, floats):
    assert kernels.trunk_bwd_f32_smem(d, w, n_layers, head, tile) \
        == 4 * floats


@pytest.mark.parametrize("d,w,n_layers,head,bf16,kernel,tile", [
    (10, 10, 20, True, False, F32, 128),       # the main path
    (10, 10, 20, False, False, F32, 128),      # --image-layers
    (10, 10, 20, True, True, BF16, 192),       # --mlp-dtype bfloat16
    (10, 10, 20, False, True, BF16, 192),      # and --image-layers
    (16, 16, 20, True, False, F32, 64),
    (24, 24, 20, True, False, F32, 32),
    (28, 28, 20, True, False, F32, 32),        # chip_smoke's wide check
    (28, 28, 20, True, True, BF16, 32),
    (16, 16, 20, True, True, BF16, 128),
    (32, 32, 20, True, True, BF16, 32),        # f32 takes trunk.cu here
    (128, 32, 20, True, True, BF16, 32),
    (128, 32, 20, False, True, BF16, 32),
    (10, 10, 60, True, True, BF16, 64),        # deep
    (10, 10, 150, True, True, GENERAL, 8),     # no warp fits
    (10, 10, 60, True, False, F32, 32),        # deep
    # f32 shapes that fit no tile of csrc/trunk_bwd.cu
    (32, 32, 20, True, False, GENERAL, 16),
    (128, 32, 20, True, False, GENERAL, 8),    # chip_smoke's wide check
    (128, 32, 20, False, False, GENERAL, 8),
    (10, 10, 150, True, False, GENERAL, 8),
])
def test_route_and_tile(d, w, n_layers, head, bf16, kernel, tile):
    """f32 takes csrc/trunk_bwd.cu and bf16 csrc/trunk_bwd_bf16.cu, at the
    most rows (warps) whose shared memory fits in a block's 227 KB; a shape
    where not even one warp fits takes csrc/trunk.cu's backward at its own
    tile."""
    assert kernels.trunk_bwd_route(d, w, n_layers, head, bf16) \
        == (kernel, tile)
    smem = {F32: kernels.trunk_bwd_f32_smem,
            BF16: kernels.trunk_bwd_bf16_smem,
            GENERAL: kernels.trunk_smem}[kernel]
    tiles = {F32: kernels.TRUNK_BWD_F32_TILES,
             BF16: kernels.TRUNK_BWD_BF16_TILES,
             GENERAL: kernels.TRUNK_BWD_TILES}[kernel]
    assert smem(d, w, n_layers, head, tile) <= kernels.MAX_SMEM_PER_BLOCK
    for taller in tiles[:tiles.index(tile)]:
        assert smem(d, w, n_layers, head, taller) \
            > kernels.MAX_SMEM_PER_BLOCK
    if kernel == GENERAL:
        own = (kernels.trunk_bwd_bf16_smem if bf16
               else kernels.trunk_bwd_f32_smem)
        assert all(own(d, w, n_layers, head, t) > kernels.MAX_SMEM_PER_BLOCK
                   for t in (kernels.TRUNK_BWD_BF16_TILES if bf16
                             else kernels.TRUNK_BWD_F32_TILES))


@pytest.mark.parametrize("d,w,n_layers,head,tile,nbytes", [
    # The main path: width 10 pads to 16, d_in 10 to 16. Shared: 202
    # biases (rounded to 204 floats) and the bf16 weights in pairs, 5 words
    # a row over 10 + 19 x 10 rows and one word a row for the head's 10
    # (1010, rounded to 1012). Per warp: its flat partial of the 2,020
    # weights and 202 biases (2,222, rounded to 2,224 floats), 20 masks of
    # 32 rows, the stash (32 rows of 16 bf16 for x and for each of 20
    # activations) and the dpre buffer (32 rows of 16 bf16)
    (10, 10, 20, True, 192,
     4 * 204 + 4 * 1012 + 6 * (4 * 2224 + 4 * 640 + 64 * (16 + 320)
                               + 64 * 16)),
    (10, 10, 20, False, 32,
     4 * 200 + 4 * 1000 + 4 * 2200 + 4 * 640 + 64 * (16 + 320) + 64 * 16),
    # width 28 pads to 32, d_in 28 to 32; 14 words a row over 28 + 19 x 28
    # rows, and 28 for the head (7868); 15,736 weights and 562 biases
    (28, 28, 20, True, 32,
     4 * 564 + 4 * 7868 + 4 * 16300 + 4 * 640 + 64 * (32 + 640) + 64 * 32),
    # d_in 128 pads to 128
    (128, 32, 20, False, 32,
     4 * 640 + 4 * (128 + 19 * 32) * 16 + 4 * (4096 + 19 * 1024 + 640)
     + 4 * 640 + 64 * (128 + 640) + 64 * 32),
    # d_in 5 pads to 16; its weights take 4 words a row over 5 + 2 x 8 rows
    # and 8 for the head (92); 184 weights and 26 biases (210, to 212)
    (5, 8, 3, True, 64,
     4 * 28 + 4 * 92 + 2 * (4 * 212 + 4 * 96 + 64 * (16 + 48) + 64 * 16)),
])
def test_bf16_smem_sum(d, w, n_layers, head, tile, nbytes):
    assert kernels.trunk_bwd_bf16_smem(d, w, n_layers, head, tile) == nbytes


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("d,w,n_layers", [
    (10, 10, 20),      # the main path and the scaler slices
    (10, 10, 60), (10, 10, 150), (16, 16, 20), (24, 24, 20), (28, 28, 20),
    (32, 32, 20), (128, 32, 20), (5, 8, 3), (7, 17, 3), (7, 1, 4),
    (200, 10, 3),      # d_in past 128 where the narrow kernels hold it
])
def test_narrow_shapes_keep_their_kernels(d, w, n_layers, head, bf16):
    """Every shape the narrow kernels took before csrc/trunk_wide.cu still
    takes them: the forward csrc/trunk.cu, the backward trunk_bwd_route's
    kernel and tile, the weights packed at trunk_width's width."""
    route = kernels.trunk_route(d, w, n_layers, head, bf16)
    kw = kernels.trunk_width(w)
    assert route.width == kw and route.fwd == kernels.TRUNK_FWD
    assert (route.bwd, route.tile) == kernels.trunk_bwd_route(
        d, kw, n_layers, head, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("d", [10, 128])
def test_widths_33_to_128_take_the_wide_kernel(d, head, bf16):
    """Every width from 33 to 128 (over 10 or 128 metadata columns) runs
    csrc/trunk_wide.cu in both directions, packed at a multiple of 16."""
    for w in range(33, 129):
        route = kernels.trunk_route(d, w, 20, head, bf16)
        assert route == (kernels.trunk_width(w), WIDE, WIDE,
                         kernels.WIDE_ROWS)
        assert route.width % 16 == 0 and w <= route.width < w + 16


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("d,w,n_layers,fwd", [
    (10, 32, 64, WIDE),           # the weights fit in no block
    (10, 10, 600, WIDE),
    (10, 32, 40, kernels.TRUNK_FWD),   # only the backward's do not
    (1024, 32, 20, kernels.TRUNK_FWD),
])
def test_narrow_shapes_past_shared_memory_take_the_wide_kernel(
        d, w, n_layers, fwd, head, bf16):
    """A narrow trunk whose weights no narrow kernel holds runs
    csrc/trunk_wide.cu where it must, and csrc/trunk.cu's forward where
    that fits; past 128 metadata columns the wide kernel refuses."""
    if d > kernels.MAX_TRUNK_WIDTH:
        with pytest.raises(ValueError, match="cap of 128"):
            kernels.trunk_route(d, w, n_layers, head, bf16)
        return
    route = kernels.trunk_route(d, w, n_layers, head, bf16)
    assert (route.width, route.fwd, route.bwd) == (w, fwd, WIDE)
    if fwd == WIDE:
        assert kernels.trunk_smem(d, w, n_layers, head) \
            > kernels.MAX_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        kernels.trunk_bwd_route(d, w, n_layers, head, bf16)


@pytest.mark.parametrize("d,w", [(10, 129), (129, 64), (200, 128)])
def test_route_refuses_past_the_jax_kernels_lanes(d, w):
    with pytest.raises(ValueError, match="cap of 128.*JAX kernel"):
        kernels.trunk_route(d, w, 3, True, False)


@pytest.mark.parametrize("d,w,bwd,floats", [
    # width 128 over d_in <= 128: two buffers of 64 rows at a stride of
    # 132 and two slots of a 128 x 128 layer and its 128 biases (the
    # backward: three buffers, one slot)
    (10, 128, False, 2 * 64 * 132 + 2 * (128 * 128 + 128)),
    (128, 128, True, 3 * 64 * 132 + 128 * 128 + 128),
    # width 33 pads to 48; d_in 10 to 12
    (10, 33, True, 3 * 64 * 52 + 48 * 48 + 48),
    # d_in 100 past width 48: 100-wide rows and a 100 x 48 first layer
    (100, 48, False, 2 * 64 * 104 + 2 * (100 * 48 + 48)),
    # d_in 7 pads to 8, width 10 to 16
    (7, 10, True, 3 * 64 * 20 + 16 * 16 + 16),
])
def test_wide_smem_sum(d, w, bwd, floats):
    assert kernels.trunk_wide_smem(d, w, bwd) == 4 * floats
    assert 4 * floats <= kernels.MAX_SMEM_PER_BLOCK


@pytest.mark.parametrize("bwd", [False, True])
def test_wide_smem_fits_at_every_width(bwd):
    assert all(kernels.trunk_wide_smem(d, w, bwd)
               <= kernels.MAX_SMEM_PER_BLOCK
               for d in range(1, 129) for w in range(1, 129))


def test_wide_launch_keys():
    keys = {kernels.trunk_key(d, h, b, wide=True) for d in ("fwd", "bwd")
            for h in (True, False) for b in (True, False)}
    narrow = {kernels.trunk_key(d, h, b) for d in ("fwd", "bwd")
              for h in (True, False) for b in (True, False)}
    assert len(keys) == 8 and keys <= set(kernels.LAUNCHES)
    assert not keys & narrow
    assert kernels.trunk_key("bwd", False, True, wide=True) \
        == "trunk_wide_only_bwd_bf16"


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
def test_wide_launchers_refuse_cpu_tensors(head, bf16):
    torch.manual_seed(0)
    layers = [{"w": torch.randn(4, 48), "b": torch.randn(48)}] + [
        {"w": torch.randn(48, 48), "b": torch.randn(48)}]
    out = {"w": torch.randn(48, 2), "b": torch.zeros(2)} if head else None
    w, b = (t.detach() for t in pack_params(layers, out, 48))
    x = torch.randn(50, 4)
    dy = (torch.randn(50), torch.randn(50)) if head else torch.randn(50, 48)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="contiguous CUDA tensors"):
        kernels.trunk_wide_fwd(x, w, b, 48, 2, 0.01, head=head, bf16=bf16)
    with pytest.raises(ValueError, match="contiguous CUDA tensors"):
        kernels.trunk_wide_bwd(x, w, b, dy, 48, 2, 0.01, False, head=head,
                               bf16=bf16)
    assert not any(kernels.LAUNCHES.values())


def test_route_refuses_what_no_kernel_holds():
    with pytest.raises(ValueError, match="shared memory"):
        kernels.trunk_bwd_route(1024, 32, 20, True, False)


def test_f32_blocks_are_whole_warps():
    for tiles in (kernels.TRUNK_BWD_F32_TILES, kernels.TRUNK_BWD_BF16_TILES):
        assert all(t % 32 == 0 for t in tiles)
        assert list(tiles) == sorted(tiles, reverse=True)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("head", [True, False])
def test_trunk_bwd_launcher_refuses_cpu_tensors(head, bf16):
    torch.manual_seed(0)
    layers = [{"w": torch.randn(4, 4), "b": torch.randn(4)}
              for _ in range(2)]
    out = {"w": torch.randn(4, 2), "b": torch.zeros(2)} if head else None
    w, b = pack_params(layers, out, 4)
    x = torch.randn(50, 4)
    dy = (torch.randn(50), torch.randn(50)) if head else torch.randn(50, 4)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="contiguous CUDA tensors"):
        kernels.trunk_bwd(x, w.detach(), b.detach(), dy, 4, 2, 0.01, False,
                          head=head, bf16=bf16)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("n,device", [(8, "cpu"), (torch.tensor(8), "cpu"),
                                      (8.0, "cpu")])
def test_philox_launcher_refuses_cpu_and_non_int_counts(n, device):
    kernels.reset_launches()
    with pytest.raises(ValueError, match="int count and a CUDA device"):
        kernels.philox_normal(n, 1, 0, torch.device(device))
    assert kernels.LAUNCHES["philox_normal"] == 0


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("mask", [False, True])
def test_fused_ll_launchers_refuse_cpu_tensors(direction, mask):
    """K4's launchers, on the gathers' launch path, refuse CPU tensors by
    name and launch nothing."""
    n = 16
    args = [torch.rand(n) + 0.5 for _ in range(6)]
    ev = torch.ones(3)
    kw = dict(kind="normal", dof=0.0, t_const=0.0, seed=1, offset=0)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="contiguous CUDA tensors.*loc"):
        if direction == "fwd":
            kernels.fused_ll_fwd(*args, torch.ones(n) if mask else None,
                                 None, ev, **kw)
        else:
            kernels.fused_ll_bwd(*args, torch.ones(n) if mask else None,
                                 None, ev, torch.tensor(1.0), **kw)
    assert not any(kernels.LAUNCHES.values())
