"""K1-bwd's two kernels: which one a shape takes, and at which tile.

csrc/trunk_bwd.cu runs the f32 backward (head or trunk only) and
csrc/trunk.cu's backward runs bf16 and the f32 shapes whose shared memory
fits no tile of the first. Both are CUDA only; what the CPU can check is
the Python side that chooses between them: kernels.trunk_bwd_f32_smem (a
copy of csrc/trunk_bwd.cu's bwd_f32_smem, held equal to it by a card test),
the tile each kernel takes, and the route. The launchers refuse CPU
tensors here, so nothing reaches a kernel. The kernels' arithmetic is
held against the JAX package through their plain versions in
tests/test_torch_fused_mlp.py and on the card in tests/test_torch_cuda.py.
"""
import pytest
import torch

from careless_tpu_torch import kernels
from careless_tpu_torch.ops.fused_mlp import pack_params

F32, GENERAL = kernels.TRUNK_BWD_F32, kernels.TRUNK_BWD_GENERAL


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
    (10, 10, 20, True, True, GENERAL, 64),     # --mlp-dtype bfloat16
    (10, 10, 20, False, True, GENERAL, 64),
    (16, 16, 20, True, False, F32, 64),
    (24, 24, 20, True, False, F32, 32),
    (28, 28, 20, True, False, F32, 32),        # chip_smoke's wide check
    (28, 28, 20, True, True, GENERAL, 32),
    (10, 10, 60, True, False, F32, 32),        # deep
    # f32 shapes that fit no tile of csrc/trunk_bwd.cu
    (32, 32, 20, True, False, GENERAL, 16),
    (128, 32, 20, True, False, GENERAL, 8),    # chip_smoke's wide check
    (128, 32, 20, False, False, GENERAL, 8),
    (10, 10, 150, True, False, GENERAL, 8),
])
def test_route_and_tile(d, w, n_layers, head, bf16, kernel, tile):
    """f32 takes csrc/trunk_bwd.cu at the most rows (warps) whose shared
    memory fits in a block's 227 KB; bf16, and f32 where not even one warp
    fits, take csrc/trunk.cu's backward at its own tile."""
    assert kernels.trunk_bwd_route(d, w, n_layers, head, bf16) \
        == (kernel, tile)
    smem = (kernels.trunk_bwd_f32_smem if kernel == F32
            else kernels.trunk_smem)
    tiles = (kernels.TRUNK_BWD_F32_TILES if kernel == F32
             else kernels.TRUNK_BWD_TILES)
    assert smem(d, w, n_layers, head, tile) <= kernels.MAX_SMEM_PER_BLOCK
    for taller in tiles[:tiles.index(tile)]:
        assert smem(d, w, n_layers, head, taller) \
            > kernels.MAX_SMEM_PER_BLOCK
    if kernel == GENERAL and not bf16:
        assert all(kernels.trunk_bwd_f32_smem(d, w, n_layers, head, t)
                   > kernels.MAX_SMEM_PER_BLOCK
                   for t in kernels.TRUNK_BWD_F32_TILES)


def test_route_refuses_what_no_kernel_holds():
    with pytest.raises(ValueError, match="shared memory"):
        kernels.trunk_bwd_route(1024, 32, 20, True, False)


def test_f32_blocks_are_whole_warps():
    assert all(t % 32 == 0 for t in kernels.TRUNK_BWD_F32_TILES)
    assert list(kernels.TRUNK_BWD_F32_TILES) == sorted(
        kernels.TRUNK_BWD_F32_TILES, reverse=True)


@pytest.mark.parametrize("head", [True, False])
def test_trunk_bwd_launcher_refuses_cpu_tensors(head):
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
                          head=head)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("n,device", [(8, "cpu"), (torch.tensor(8), "cpu"),
                                      (8.0, "cpu")])
def test_philox_launcher_refuses_cpu_and_non_int_counts(n, device):
    kernels.reset_launches()
    with pytest.raises(ValueError, match="int count and a CUDA device"):
        kernels.philox_normal(n, 1, 0, torch.device(device))
    assert kernels.LAUNCHES["philox_normal"] == 0
