"""csrc/trunk.cu's forward: its rows a thread, its grid and its route.

The kernel is CUDA only; what the CPU can check is the launcher's arithmetic
(kernels.trunk_fwd_rows and kernels.trunk_fwd_blocks, copies of the kernel's
fwd_rows and launch limits, held equal to them by a card test) and that the
forward's shared-memory sum, and with it every route, is what it was: the
flat weights and biases (kernels.trunk_smem at tile 0). The forward's
arithmetic is held bit for bit against csrc/trunk_wide.cu's and against the
plain version on the card (tests/test_torch_cuda.py).
"""
import pytest

from careless_tpu_torch import kernels

H100_SMS = 132


@pytest.mark.parametrize("width,rows", [(1, 4), (8, 4), (10, 4), (11, 2),
                                        (12, 2), (16, 2), (20, 2), (24, 1),
                                        (28, 1), (32, 1)])
def test_rows_a_thread(width, rows):
    """4 rows a thread up to width 10, 2 up to 20, 1 above: the rows'
    activations and sums, 2 R W floats, never more than 80 of the 128
    registers the launch bounds give a thread (at 96, widths 12 and 24,
    ptxas spilled)."""
    assert kernels.trunk_fwd_rows(width) == rows
    assert 2 * rows * width <= 80


@pytest.mark.parametrize("n,d,w,n_layers,head,sms,blocks", [
    # the main path and the Laue step: 2 blocks of 8 warps on each SM
    (1_000_000, 10, 10, 20, True, H100_SMS, 264),
    (10_000_000, 10, 10, 20, True, H100_SMS, 264),
    (1_000_000, 10, 10, 20, False, H100_SMS, 264),
    # an H100 PCIe's 114 SMs
    (1_000_000, 10, 10, 20, True, 114, 228),
    # few rows: no more blocks than their tiles of 128 rows need, 8 a block
    (1, 10, 10, 20, True, H100_SMS, 1),
    (1_024, 10, 10, 20, True, H100_SMS, 1),
    (1_025, 10, 10, 20, True, H100_SMS, 2),
    (100_003, 10, 10, 20, True, H100_SMS, 98),
    # 2 rows a thread (tiles of 64) and 1 (tiles of 32)
    (100_003, 7, 17, 3, False, H100_SMS, 196),
    (100_003, 128, 32, 20, True, H100_SMS, 264),
    (5_001, 128, 32, 20, True, H100_SMS, 20),
    # weights of 166 KB (width 32, 40 layers): one block a SM
    (1_000_000, 10, 32, 40, True, H100_SMS, 132),
])
def test_grid(n, d, w, n_layers, head, sms, blocks):
    assert kernels.trunk_fwd_blocks(n, d, w, n_layers, head, sms) == blocks


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("d,w,n_layers", [(10, 10, 20), (7, 17, 3),
                                          (128, 32, 20), (10, 32, 40)])
def test_grid_is_what_is_resident(d, w, n_layers, sms):
    """At most TRUNK_FWD_WARPS_PER_SM warps a SM, and as many blocks as
    shared memory holds; a large n fills the card, a small one takes the
    blocks its tiles need."""
    smem = kernels.trunk_smem(d, w, n_layers, True)
    per_sm = min(kernels.TRUNK_FWD_WARPS_PER_SM // kernels.TRUNK_FWD_WARPS,
                 kernels.SMEM_PER_SM // (smem + 1024))
    assert per_sm >= 1
    assert kernels.trunk_fwd_blocks(10 ** 8, d, w, n_layers, True,
                                    sms) == per_sm * sms
    tile = 32 * kernels.trunk_fwd_rows(w)
    n = 3 * tile * kernels.TRUNK_FWD_WARPS + 1
    assert kernels.trunk_fwd_blocks(n, d, w, n_layers, True, sms) \
        == min(4, per_sm * sms)


def test_grid_refuses_weights_past_a_block():
    with pytest.raises(ValueError, match="shared memory in the forward"):
        kernels.trunk_fwd_blocks(1_000, 10, 32, 64, True, H100_SMS)


@pytest.mark.parametrize("d,w,n_layers,head,floats", [
    # the flat weights and biases, nothing else: d_in x W, (L - 1) W x W,
    # the head's W x 2; L W biases and the head's 2
    (10, 10, 20, True, 100 + 19 * 100 + 20 + 200 + 2),
    (10, 10, 20, False, 100 + 19 * 100 + 200),
    (128, 32, 20, True, 4096 + 19 * 1024 + 64 + 640 + 2),
    (5, 8, 3, False, 40 + 2 * 64 + 24),
    (7, 20, 3, True, 140 + 2 * 400 + 40 + 60 + 2),
])
def test_forward_smem_is_the_flat_parameters(d, w, n_layers, head, floats):
    assert kernels.trunk_smem(d, w, n_layers, head) == 4 * floats


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("w", kernels.TRUNK_WIDTHS)
def test_narrow_forward_route_is_the_weights_fit(w, head):
    """Every shape whose flat weights and biases fit in a block takes
    csrc/trunk.cu's forward, as before this kernel's redesign, and its
    grid is defined; every other takes csrc/trunk_wide.cu's. Swept over
    d_in up to the 128 the wide kernel holds and depths to the edge."""
    for d in (1, 2, 5, 10, 16, 17, 64, 100, 128):
        edge = (kernels.MAX_SMEM_PER_BLOCK // 4 - d * w) // (w * w + w) + 2
        for n_layers in sorted({1, 2, 3, 20, max(1, edge - 2), edge - 1,
                                edge, edge + 1}):
            params = (d * w + (n_layers - 1) * w * w + n_layers * w
                      + ((2 * w + 2) if head else 0))
            fits = 4 * params <= kernels.MAX_SMEM_PER_BLOCK
            route = kernels.trunk_route(d, w, n_layers, head, False)
            assert route.fwd == (kernels.TRUNK_FWD if fits
                                 else kernels.TRUNK_WIDE), (d, n_layers)
            if fits:
                assert kernels.trunk_fwd_blocks(1_000_000, d, w, n_layers,
                                                head, H100_SMS) >= 1
