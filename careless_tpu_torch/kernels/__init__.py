"""Launchers for the port's CUDA kernels (csrc/), with their launch counts.

Each launcher takes CUDA tensors only, checks device, type, shape and
contiguity, allocates its outputs with torch.empty, launches on PyTorch's
current stream and raises if the launch was refused. `LAUNCHES[name]` grows
by one for every call that launches its kernel; nothing else touches it.
The ops modules decide between these launchers and the plain versions by
the device of the tensors they are given.

K1-fwd has two kernels: csrc/trunk.cu for kernel widths up to 32 whose
weights fit in a block's shared memory, and csrc/trunk_wide.cu, which
streams the weights one layer at a time, for the rest up to the JAX
kernel's 128 lanes. K1-bwd has four: csrc/trunk_bwd.cu for f32 and
csrc/trunk_bwd_bf16.cu (tensor-core mma) for bf16 operands, each head or
trunk only, csrc/trunk.cu's backward for the shapes whose shared memory
fits not even one warp of those two (`trunk_bwd_route` decides, by shape),
and csrc/trunk_wide.cu for the shapes none of them holds. `trunk_route`
picks both directions' kernels for a shape.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ._build import library

LAUNCHES = {"trunk_fwd": 0, "trunk_bwd": 0, "trunk_fwd_bf16": 0,
            "trunk_bwd_bf16": 0, "trunk_only_fwd": 0, "trunk_only_bwd": 0,
            "trunk_only_fwd_bf16": 0, "trunk_only_bwd_bf16": 0, "gather": 0,
            "philox_normal": 0, "fused_ll_fwd": 0, "fused_ll_bwd": 0,
            "gather_stream": 0, "trunk_wide_fwd": 0, "trunk_wide_bwd": 0,
            "trunk_wide_fwd_bf16": 0, "trunk_wide_bwd_bf16": 0,
            "trunk_wide_only_fwd": 0, "trunk_wide_only_bwd": 0,
            "trunk_wide_only_fwd_bf16": 0, "trunk_wide_only_bwd_bf16": 0}

# csrc/fused_ll.cu's kinds, in the order of its Kind enum
FUSED_KINDS = ("normal", "studentt", "laplace", "normal_ev11",
               "studentt_ev11")

# widths with an instantiated trunk kernel (csrc/trunk.cu CT_TRUNK_WIDTHS)
TRUNK_WIDTHS = tuple(range(1, 17)) + (20, 24, 28, 32)
# csrc/trunk.cu's backward's tile heights (its block sizes), tallest first
TRUNK_BWD_TILES = (64, 32, 16, 8)
# csrc/trunk_bwd.cu's and csrc/trunk_bwd_bf16.cu's block rows, most first:
# each warp of a block walks tiles of 32 rows of its own
TRUNK_BWD_F32_TILES = (128, 64, 32)
# the three K1-bwd kernels, as trunk_bwd_route names them
TRUNK_BWD_F32, TRUNK_BWD_GENERAL = "csrc/trunk_bwd.cu", "csrc/trunk.cu"
TRUNK_BWD_BF16 = "csrc/trunk_bwd_bf16.cu"
# K1-fwd's narrow kernel, and the kernel of both directions for the shapes
# the others do not take (trunk_route)
TRUNK_FWD, TRUNK_WIDE = "csrc/trunk.cu", "csrc/trunk_wide.cu"
# csrc/trunk_wide.cu: its widths (multiples of 16, up to the JAX kernel's
# 128 lanes, which bound max(d_in, width) there too) and its tile's rows
WIDE_STEP, MAX_TRUNK_WIDTH, WIDE_ROWS = 16, 128, 64
# csrc/trunk_bwd_bf16.cu's block rows, most first: 8 to 1 warps, each
# walking tiles of 32 rows of its own
TRUNK_BWD_BF16_TILES = tuple(32 * w for w in range(8, 0, -1))
MAX_SMEM_PER_BLOCK = 232448    # H100: 227 KB of dynamic shared memory
SMEM_PER_SM = 233472           # H100: 228 KB per SM, 1 KB reserved per block


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def trunk_key(direction: str, head: bool, bf16: bool,
              wide: bool = False) -> str:
    """The LAUNCHES name of one K1 instantiation: direction "fwd" or
    "bwd", with the head or the trunk only, f32 or bf16 operands, in
    csrc/trunk_wide.cu (wide) or in one of the narrow kernels."""
    return ("trunk_" + ("wide_" if wide else "") + ("" if head else "only_")
            + direction + ("_bf16" if bf16 else ""))


def trunk_width(width: int) -> int:
    """The kernel width a trunk of `width` runs at (the wrapper zero-pads
    the weights up to it, which is exact): an instantiated width of
    csrc/trunk.cu up to 32, else the next multiple of 16 up to 128."""
    for w in TRUNK_WIDTHS:
        if w >= width:
            return w
    if width <= MAX_TRUNK_WIDTH:
        return _wide_kw(width)
    raise ValueError(_past_the_lanes("MLP width", width))


def _wide_kw(width: int) -> int:
    """csrc/trunk_wide.cu's own width: `width` rounded up to WIDE_STEP."""
    return -(-width // WIDE_STEP) * WIDE_STEP


def _past_the_lanes(what: str, value: int) -> str:
    return (f"{what} {value} exceeds the trunk kernels' cap of "
            f"{MAX_TRUNK_WIDTH}, the 128 lanes of the JAX kernel "
            "(careless_tpu/ops/fused_mlp.py), whose domain the port keeps")


@functools.cache
def trunk_smem(d_in: int, width: int, n_layers: int, head: bool,
               tile: int = 0) -> int:
    """Shared-memory bytes of K1 at a kernel width: the forward's (tile 0)
    or the backward's at tile height `tile`. The same sums as csrc/
    trunk.cu's fwd_smem and bwd_smem (ct_trunk_smem; a card test holds the
    two equal): the weights and biases, twice in the backward (values and
    partials), and the backward's d_in + L W + max(W, 2) rows of tile + 1
    floats."""
    params = (d_in * width + (n_layers - 1) * width * width
              + n_layers * width + ((2 * width + 2) if head else 0))
    if not tile:
        return 4 * params
    rows = d_in + n_layers * width + max(width, 2)
    return 4 * (2 * params + rows * (tile + 1))


def trunk_bwd_tile(d_in: int, width: int, n_layers: int, head: bool) -> int:
    """The tallest backward tile whose shared memory fits in a block."""
    for tile in TRUNK_BWD_TILES:
        if trunk_smem(d_in, width, n_layers, head, tile) <= MAX_SMEM_PER_BLOCK:
            return tile
    need = trunk_smem(d_in, width, n_layers, head, TRUNK_BWD_TILES[-1])
    raise ValueError(
        f"trunk of {n_layers} layers at width {width} (d_in {d_in}) needs "
        f"{need} bytes of shared memory in the backward at its shortest "
        f"tile of {TRUNK_BWD_TILES[-1]} rows; the card allows "
        f"{MAX_SMEM_PER_BLOCK}")


def _quads(n: int) -> int:
    return -(-n // 4)


@functools.cache
def trunk_bwd_f32_smem(d_in: int, width: int, n_layers: int, head: bool,
                       tile: int) -> int:
    """Shared-memory bytes of the f32 K1-bwd (csrc/trunk_bwd.cu) for a block
    of `tile` rows (tile / 32 warps) at a kernel width: the same sum as its
    bwd_f32_smem (ct_trunk_bwd_f32_smem; a card test holds the two equal).
    The weights and biases flat (rounded up to a quad of floats), shared by
    the block; then for each warp its dW partial at 16 floats per 4x4 item
    of every layer, its db partial at a quad per 4 columns of every layer,
    and its 32-row stash: x
    and a_1..a_L, each row at a stride of an odd number of quads, and one
    quad for the head's cotangent."""
    q = _quads(width)

    def stride(k: int) -> int:
        return 4 * (_quads(k) | 1)
    params = (d_in * width + (n_layers - 1) * width * width
              + n_layers * width + ((2 * width + 2) if head else 0))
    items = _quads(d_in) * q + (n_layers - 1) * q * q + (q if head else 0)
    stash = stride(d_in) + n_layers * stride(width) + (4 if head else 0)
    warp = (16 * items + 4 * (n_layers * q + (1 if head else 0))
            + 32 * stash)
    return 4 * (4 * _quads(params) + tile // 32 * warp)


@functools.cache
def trunk_bwd_bf16_smem(d_in: int, width: int, n_layers: int, head: bool,
                        tile: int) -> int:
    """Shared-memory bytes of the bf16 K1-bwd (csrc/trunk_bwd_bf16.cu) for a
    block of `tile` rows (tile / 32 warps) at a kernel width: the same sum
    as its bwd_bf16_smem (ct_trunk_bwd_bf16_smem; a card test holds the two
    equal). The width pads to kw = 16 or 32 and d_in to dx, a multiple of
    16. Shared by the block: the biases (f32) and the weights as bf16 pairs
    ((width + 1) // 2 words a row, one a row for the head), each rounded up
    to a quad. For each warp, whose tile has 32 rows: its partial of dW and
    db (f32, flat, rounded up to a quad); a 32-bit mask per row and layer;
    the stash, its rows of bf16 x (dx) and a_1..a_L (kw each); the dpre
    buffer, its rows of kw bf16."""
    kw, dx = (16 if width <= 16 else 32), -(-d_in // 16) * 16
    rows = 32
    nw = (d_in * width + (n_layers - 1) * width * width
          + (2 * width if head else 0))
    nb = n_layers * width + (2 if head else 0)
    words = ((d_in + (n_layers - 1) * width) * ((width + 1) // 2)
             + (width if head else 0))
    warp = (16 * _quads(nw + nb) + 4 * rows * n_layers
            + 2 * rows * (dx + n_layers * kw) + 2 * rows * kw)
    return 16 * (_quads(nb) + _quads(words)) + tile // rows * warp


@functools.cache
def trunk_bwd_route(d_in: int, width: int, n_layers: int, head: bool,
                    bf16: bool) -> Tuple[str, int]:
    """The K1-bwd kernel for a shape at a kernel width, and its tile: f32
    takes csrc/trunk_bwd.cu (TRUNK_BWD_F32) at the tallest of
    TRUNK_BWD_F32_TILES, bf16 csrc/trunk_bwd_bf16.cu (TRUNK_BWD_BF16) at
    the tallest of TRUNK_BWD_BF16_TILES, whose shared memory fits a block; a shape that fits none of them takes
    csrc/trunk.cu's backward (TRUNK_BWD_GENERAL) at trunk_bwd_tile's
    tile."""
    kernel, smem, tiles = (
        (TRUNK_BWD_BF16, trunk_bwd_bf16_smem, TRUNK_BWD_BF16_TILES) if bf16
        else (TRUNK_BWD_F32, trunk_bwd_f32_smem, TRUNK_BWD_F32_TILES))
    for tile in tiles:
        if smem(d_in, width, n_layers, head, tile) <= MAX_SMEM_PER_BLOCK:
            return kernel, tile
    return TRUNK_BWD_GENERAL, trunk_bwd_tile(d_in, width, n_layers, head)


def trunk_wide_smem(d_in: int, width: int, bwd: bool) -> int:
    """Shared-memory bytes of csrc/trunk_wide.cu (the same sum as its
    wide_smem, ct_trunk_wide_smem; a card test holds the two equal): at kw =
    width rounded up to 16, d4 = d_in rounded up to 4 and cols = max(d4,
    kw), buffers of WIDE_ROWS rows at a stride of cols + 4 floats (two in
    the forward, three in the backward) and slots of one layer's weights
    (cols x kw) and biases (kw) (two in the forward, one in the
    backward)."""
    kw = _wide_kw(width)
    cols = max(-(-d_in // 4) * 4, kw)
    return 4 * ((3 if bwd else 2) * WIDE_ROWS * (cols + 4)
                + (1 if bwd else 2) * (cols * kw + kw))


class TrunkRoute(NamedTuple):
    """The kernels a trunk runs on the card: the width its weights are
    packed at, each direction's kernel (TRUNK_FWD or TRUNK_WIDE forward;
    TRUNK_BWD_F32, TRUNK_BWD_BF16, TRUNK_BWD_GENERAL or TRUNK_WIDE
    backward) and the backward's tile."""
    width: int
    fwd: str
    bwd: str
    tile: int


@functools.cache
def trunk_route(d_in: int, width: int, n_layers: int, head: bool,
                bf16: bool) -> TrunkRoute:
    """Both directions' K1 kernels for a trunk of the model's `width`.
    Every shape the narrow kernels hold keeps them: the forward csrc/
    trunk.cu where its weights fit in a block, the backward trunk_bwd_route's
    kernel. The rest, up to max(d_in, width) = 128, takes csrc/trunk_wide.cu
    (both directions run K1-fwd's order of sums, so a forward and a
    backward in different kernels see the same activations). Raises past
    128, the JAX kernel's lanes."""
    kw = trunk_width(width)
    narrow = kw <= TRUNK_WIDTHS[-1]
    fwd = (TRUNK_FWD if narrow and trunk_smem(d_in, kw, n_layers, head)
           <= MAX_SMEM_PER_BLOCK else TRUNK_WIDE)
    bwd, tile = TRUNK_WIDE, WIDE_ROWS
    if narrow:
        try:
            bwd, tile = trunk_bwd_route(d_in, kw, n_layers, head, bf16)
        except ValueError:   # no narrow backward holds the shape
            pass
    if TRUNK_WIDE in (fwd, bwd) and d_in > MAX_TRUNK_WIDTH:
        raise ValueError(_past_the_lanes("metadata width (d_in)", d_in))
    return TrunkRoute(kw, fwd, bwd, tile)


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = library().ct_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# The launch path of every kernel: one expression of cheap checks
# (type, device, contiguity), outputs sized by ints, and _launch, which
# enters the device context only when the tensors are not on the current
# device and reads the raw stream handle without building a Stream object.
_F32, _I32 = torch.float32, torch.int32


def _f32_card(*ts: torch.Tensor) -> int:
    """The device index of ts when all are contiguous float32 tensors on one
    CUDA device, else -1."""
    idx = ts[0].get_device()
    for t in ts:
        if (t.dtype is not _F32 or t.get_device() != idx
                or not t.is_contiguous()):
            return -1
    return idx


def _refuse(what: str, takes: str, *named) -> None:
    got = ", ".join(f"{name} {t.dtype} on {t.device}"
                    + ("" if t.is_contiguous() else " (not contiguous)")
                    for name, t in named)
    raise ValueError(f"{what} takes contiguous CUDA tensors on one device: "
                     f"{takes}; got {got}")


def _launch(fn, idx: int, *args) -> int:
    """Call a kernel's C entry point on PyTorch's current stream of device
    `idx`, entering that device's context only when it is not current."""
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def trunk_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              width: int, n_layers: int, leak: float, *, head: bool = True,
              out_w: Optional[int] = None, bf16: bool = False):
    """K1-fwd from metadata x (N, d_in) and the flat packed weights/biases
    of csrc/trunk.cu at an instantiated width: flat (N,) loc and raw with
    the head; else the (N, out_w) activations of the last layer (out_w,
    the model's width, defaults to the kernel's). bf16 rounds both
    operands of every product to bf16."""
    idx = _f32_card(x, w, b)
    if idx < 0:
        _refuse("trunk forward", "float32 x, w and b", ("x", x), ("w", w),
                ("b", b))
    n, d_in = x.shape
    out_w = width if out_w is None else out_w
    smem = trunk_smem(d_in, width, n_layers, head)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"trunk of {n_layers} layers at width {width} "
                         f"(d_in {d_in}) needs {smem} bytes of shared memory "
                         f"in the forward; the card allows "
                         f"{MAX_SMEM_PER_BLOCK}")
    dev = x.device
    if head:
        outs = (torch.empty(n, dtype=_F32, device=dev),
                torch.empty(n, dtype=_F32, device=dev))
    else:
        outs = (torch.empty((n, out_w), dtype=_F32, device=dev),)
    err = _launch(library().ct_trunk_fwd, idx, x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), outs[0].data_ptr(),
                  outs[-1].data_ptr() if head else None, n, d_in, width,
                  n_layers, int(head), out_w, int(bf16), leak)
    _check(err, "trunk forward")
    LAUNCHES[trunk_key("fwd", head, bf16)] += 1
    return outs if head else outs[0]


@functools.cache
def _sm_count(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def _trunk_bwd_blocks(n: int, smem: int, tile: int, idx: int) -> int:
    """The backward's fixed grid: as many blocks as fit on the card at once,
    never more than there are tiles. Fixed for a given shape and card, so
    the reduction order, and with it dW, is repeatable bit for bit."""
    per_sm = max(1, SMEM_PER_SM // (smem + 1024))
    tiles = -(-n // tile)
    return max(1, min(tiles, per_sm * _sm_count(idx)))


_BWD_SMEM = {TRUNK_BWD_F32: trunk_bwd_f32_smem,
             TRUNK_BWD_BF16: trunk_bwd_bf16_smem,
             TRUNK_BWD_GENERAL: trunk_smem}
_BWD_ENTRY = {TRUNK_BWD_F32: "ct_trunk_bwd_f32",
              TRUNK_BWD_BF16: "ct_trunk_bwd_bf16"}


def trunk_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy,
              width: int, n_layers: int, leak: float, need_dx: bool, *,
              head: bool = True, bf16: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1-bwd: (dw, db, dx) for the flat packed weights/biases, from the
    cotangent dy: the pair (dloc, draw) of (N,) with the head, else the
    (N, out_w) cotangent of the last layer's activations. dx only when
    asked for (metadata takes no gradient on the training path). The
    kernel is trunk_bwd_route's: csrc/trunk_bwd.cu for f32 and
    csrc/trunk_bwd_bf16.cu for bf16 where they fit, csrc/trunk.cu's
    backward otherwise."""
    dys = tuple(dy) if head else (dy,)
    idx = _f32_card(x, w, b, *dys)
    if idx < 0:
        _refuse("trunk backward", "float32 x, w, b and dy",
                ("x", x), ("w", w), ("b", b),
                *((f"dy[{i}]", t) for i, t in enumerate(dys)))
    n, d_in = x.shape
    out_w = 0 if head else dy.shape[1]
    if not head and (dy.shape[0] != n or not 1 <= out_w <= width):
        raise ValueError(f"dy must have shape ({n}, <= {width}); got "
                         f"{tuple(dy.shape)}")
    kernel, tile = trunk_bwd_route(d_in, width, n_layers, head, bf16)
    smem = _BWD_SMEM[kernel](d_in, width, n_layers, head, tile)
    n_blocks = _trunk_bwd_blocks(n, smem, tile, idx)
    nw, nb = w.numel(), b.numel()
    dev = x.device
    part = torch.empty((n_blocks, nw + nb), dtype=_F32, device=dev)
    out = torch.empty(nw + nb, dtype=_F32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), dys[0].data_ptr(),
            dys[1].data_ptr() if head else None,
            None if dx is None else dx.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, d_in, width, n_layers, int(head), out_w)
    if kernel != TRUNK_BWD_GENERAL:
        err = _launch(getattr(library(), _BWD_ENTRY[kernel]), idx, *args,
                      tile, n_blocks, leak)
    else:
        err = _launch(library().ct_trunk_bwd, idx, *args, int(bf16), tile,
                      n_blocks, leak)
    _check(err, "trunk backward")
    LAUNCHES[trunk_key("bwd", head, bf16)] += 1
    return out[:nw], out[nw:], dx


def _wide_shape(what: str, d_in: int, width: int) -> None:
    if d_in > MAX_TRUNK_WIDTH or width > MAX_TRUNK_WIDTH:
        raise ValueError(_past_the_lanes(f"{what}: max(d_in, width)",
                                         max(d_in, width)))


def trunk_wide_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   width: int, n_layers: int, leak: float, *,
                   head: bool = True, out_w: Optional[int] = None,
                   bf16: bool = False):
    """K1-fwd in csrc/trunk_wide.cu: as trunk_fwd, for any packed width and
    d_in up to 128 at any depth (the weights stream one layer at a time)."""
    idx = _f32_card(x, w, b)
    if idx < 0:
        _refuse("wide trunk forward", "float32 x, w and b", ("x", x),
                ("w", w), ("b", b))
    n, d_in = x.shape
    _wide_shape("wide trunk forward", d_in, width)
    out_w = width if out_w is None else out_w
    dev = x.device
    if head:
        outs = (torch.empty(n, dtype=_F32, device=dev),
                torch.empty(n, dtype=_F32, device=dev))
    else:
        outs = (torch.empty((n, out_w), dtype=_F32, device=dev),)
    err = _launch(library().ct_trunk_wide_fwd, idx, x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), outs[0].data_ptr(),
                  outs[-1].data_ptr() if head else None, n, d_in, width,
                  n_layers, int(head), out_w, int(bf16), leak)
    _check(err, "wide trunk forward")
    LAUNCHES[trunk_key("fwd", head, bf16, wide=True)] += 1
    return outs if head else outs[0]


@functools.cache
def _wide_blocks_per_card(d_in: int, width: int, idx: int) -> int:
    """Blocks of csrc/trunk_wide.cu's backward resident on the card at
    once, by its shared memory and its 4 kw threads a block."""
    smem = trunk_wide_smem(d_in, width, True)
    threads = 4 * _wide_kw(width)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads))
    return per_sm * _sm_count(idx)


def trunk_wide_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy,
                   width: int, n_layers: int, leak: float, need_dx: bool, *,
                   head: bool = True, bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """K1-bwd in csrc/trunk_wide.cu: as trunk_bwd, for any packed width and
    d_in up to 128 at any depth. A fixed grid (as many blocks as the card
    holds at once, never more than there are tiles of WIDE_ROWS rows), so
    dW and db repeat bit for bit; each block stashes its tile's activations
    in a scratch of its own."""
    dys = tuple(dy) if head else (dy,)
    idx = _f32_card(x, w, b, *dys)
    if idx < 0:
        _refuse("wide trunk backward", "float32 x, w, b and dy",
                ("x", x), ("w", w), ("b", b),
                *((f"dy[{i}]", t) for i, t in enumerate(dys)))
    n, d_in = x.shape
    _wide_shape("wide trunk backward", d_in, width)
    out_w = 0 if head else dy.shape[1]
    if not head and (dy.shape[0] != n or not 1 <= out_w <= width):
        raise ValueError(f"dy must have shape ({n}, <= {width}); got "
                         f"{tuple(dy.shape)}")
    n_blocks = max(1, min(-(-n // WIDE_ROWS),
                          _wide_blocks_per_card(d_in, width, idx)))
    nw, nb = w.numel(), b.numel()
    dev = x.device
    part = torch.empty((n_blocks, nw + nb), dtype=_F32, device=dev)
    stash = torch.empty(n_blocks * max(n_layers - 1, 1) * WIDE_ROWS
                        * _wide_kw(width),
                        dtype=_F32, device=dev)
    out = torch.empty(nw + nb, dtype=_F32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    err = _launch(library().ct_trunk_wide_bwd, idx, x.data_ptr(),
                  w.data_ptr(), b.data_ptr(), dys[0].data_ptr(),
                  dys[1].data_ptr() if head else None,
                  None if dx is None else dx.data_ptr(), part.data_ptr(),
                  stash.data_ptr(), out.data_ptr(), n, d_in, width, n_layers,
                  int(head), out_w, int(bf16), n_blocks, leak)
    _check(err, "wide trunk backward")
    LAUNCHES[trunk_key("bwd", head, bf16, wide=True)] += 1
    return out[:nw], out[nw:], dx


# The gathers' ids come from plans (ops/plan_gather.py), which check once,
# when they are built, that the ids are int32, contiguous, 16-byte aligned
# on the card and inside their table. So a gather launch checks only what is
# cheap and what a caller could still get wrong: CUDA f32 table, int32 ids
# on its device, both contiguous.
_GATHER_TAKES = "a float32 table and int32 ids"


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K2: table[ids] for a flat f32 table and int32 ids whose range the
    caller has validated (make_gather_plan does, once, on the host)."""
    idx = table.get_device()
    if (table.dtype is not _F32 or ids.dtype is not _I32 or idx < 0
            or ids.get_device() != idx or not table.is_contiguous()
            or not ids.is_contiguous()):
        _refuse("gather", _GATHER_TAKES, ("table", table), ("ids", ids))
    if ids.data_ptr() & 15:
        ids = ids.clone()  # a view off a plan: the kernel loads 16 bytes
    n = ids.numel()
    # a size as an int: torch.empty parses a torch.Size far more slowly
    out = torch.empty(n, dtype=_F32, device=table.device)
    err = _launch(library().ct_gather, idx, table.data_ptr(), ids.data_ptr(),
                  out.data_ptr(), n)
    _check(err, "gather")
    LAUNCHES["gather"] += 1
    return out if ids.dim() == 1 else out.view(ids.shape)


def stream_smem(window: int) -> int:
    """Shared-memory bytes of K5 at a window of `window` rows of 128: the
    same sum as csrc/gather_stream.cu's smem_bytes (ct_gather_stream_smem; a
    card test holds the two equal): a 16-byte mbarrier slot, the window and
    the up to 3 floats of its alignment shift, rounded to 16 bytes."""
    return 16 + 4 * (window * 128 + 4)


def gather_stream(table: torch.Tensor, ids2d: torch.Tensor,
                  bases: torch.Tensor, window: int, block_rows: int
                  ) -> torch.Tensor:
    """K5: (R * 128,) windowed gather of a flat f32 table by (R, 128) int32
    id tiles, block_rows rows to a tile, tile i reading table rows
    [bases[i], bases[i] + window) of 128 entries (ops/table_gather.py,
    whose windowed_gather_stream checks the tile shapes)."""
    idx = table.get_device()
    if (table.dtype is not _F32 or ids2d.dtype is not _I32
            or bases.dtype is not _I32 or idx < 0
            or ids2d.get_device() != idx or bases.get_device() != idx
            or not table.is_contiguous() or not ids2d.is_contiguous()
            or not bases.is_contiguous()):
        _refuse("gather_stream", _GATHER_TAKES, ("table", table),
                ("ids2d", ids2d), ("bases", bases))
    smem = stream_smem(window)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"gather_stream: a window of {window} chunks needs "
                         f"{smem} bytes of shared memory; the card allows "
                         f"{MAX_SMEM_PER_BLOCK}")
    if ids2d.data_ptr() & 15:
        ids2d = ids2d.clone()  # the kernel loads ids 16 bytes at a time
    out = torch.empty(ids2d.numel(), dtype=_F32, device=table.device)
    err = _launch(library().ct_gather_stream, idx, table.data_ptr(),
                  table.shape[0], ids2d.data_ptr(), bases.data_ptr(),
                  out.data_ptr(), bases.shape[0], block_rows * 128, window)
    _check(err, "gather_stream")
    LAUNCHES["gather_stream"] += 1
    return out


def philox_normal(n: int, seed: int, offset: int, device: torch.device,
                  with_bits: bool = False):
    """K3: (n,) standard normals of indices offset .. offset + n - 1 under
    the 64-bit key `seed` on a CUDA device; with_bits also returns the
    (n, 2) raw words each element used, (r0, r1) or (r2, r3) of its Philox
    block, as int32 for bitwise comparison with the plain version."""
    if device.type != "cuda" or type(n) is not int:
        raise ValueError(f"the Philox kernel takes an int count and a CUDA "
                         f"device; got {type(n).__name__} {n} and {device}")
    idx = torch.cuda.current_device() if device.index is None else device.index
    out = torch.empty(n, dtype=_F32, device=device)
    bits = (torch.empty((n, 2), dtype=_I32, device=device) if with_bits
            else None)
    err = _launch(library().ct_philox_normal, idx, out.data_ptr(),
                  None if bits is None else bits.data_ptr(), n,
                  seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, offset)
    _check(err, "philox normal")
    LAUNCHES["philox_normal"] += 1
    return (out, bits) if with_bits else out


_FUSED_TAKES = "float32 loc, scale, a, f, iobs, sig, ev[, mask, noise, ct]"
_FUSED_THREADS = 256   # csrc/fused_ll.cu's THREADS: one partial a block


def fused_ll_parts(n: int) -> int:
    """K4's partial sums for n observations: csrc/fused_ll.cu's
    ct_fused_ll_parts (a card test holds the two equal), at least 1."""
    return max(1, -(-n // _FUSED_THREADS))


def _fused_ll_inputs(what, loc, scale, a, f, iobs, sig, mask, noise, ev,
                     kind, *more):
    """Checks K4's inputs (and `more`, the backward's cotangent) as the
    gathers' launchers do, in one expression of cheap checks; returns (the
    device index, n, kind index, the optional pointers)."""
    named = [(name, t) for name, t in zip(
        ("loc", "scale", "a", "f", "iobs", "sig", "ev", "mask", "noise",
         "ct"), (loc, scale, a, f, iobs, sig, ev, mask, noise, *more))
        if t is not None]
    opt = tuple(t for t in (mask, noise) if t is not None)
    idx = _f32_card(*(t for _, t in named))
    if idx < 0:
        _refuse(what, _FUSED_TAKES, *named)
    n = loc.shape[0]
    for t in (loc, scale, a, f, iobs, sig) + opt:
        if t.shape != (n,):
            raise ValueError(f"{what}: every per-observation input must have "
                             f"shape ({n},); got {tuple(t.shape)}")
    if ev.shape != (3,):
        raise ValueError(f"{what}: ev must have shape (3,); got "
                         f"{tuple(ev.shape)}")
    if kind not in FUSED_KINDS:
        raise ValueError(f"unsupported fused likelihood kind: {kind}")
    return (idx, n, FUSED_KINDS.index(kind),
            None if mask is None else mask.data_ptr(),
            None if noise is None else noise.data_ptr())


def fused_ll_fwd(loc, scale, a, f, iobs, sig, mask, noise, ev, *, kind: str,
                 dof: float, t_const: float, seed: int, offset: int
                 ) -> torch.Tensor:
    """K4-fwd: the 0-d sum over observations of mask * ll(kind) at
    ipred = (a loc + |a| scale eps) f^2, with eps = noise or, when noise is
    None, the Philox normals of K3 of indices offset .. offset + n - 1
    under the 64-bit key `seed`. mask may be None (ones); ev holds the
    three Ev11 scalars (read by the Ev11 kinds only); t_const is the
    Student-t log normaliser of `dof`."""
    idx, n, k, mask_p, noise_p = _fused_ll_inputs(
        "fused likelihood forward", loc, scale, a, f, iobs, sig, mask, noise,
        ev, kind)
    dev = loc.device
    part = torch.empty(fused_ll_parts(n), dtype=_F32, device=dev)
    out = torch.empty((), dtype=_F32, device=dev)
    err = _launch(library().ct_fused_ll_fwd, idx, loc.data_ptr(),
                  scale.data_ptr(), a.data_ptr(), f.data_ptr(),
                  iobs.data_ptr(), sig.data_ptr(), mask_p, noise_p,
                  ev.data_ptr(), part.data_ptr(), out.data_ptr(), n, k, dof,
                  t_const, seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                  offset)
    _check(err, "fused likelihood forward")
    LAUNCHES["fused_ll_fwd"] += 1
    return out


def fused_ll_bwd(loc, scale, a, f, iobs, sig, mask, noise, ev,
                 ct: torch.Tensor, *, kind: str, dof: float, t_const: float,
                 seed: int, offset: int):
    """K4-bwd: ct * (dloc, dscale, da, df), each (n,), and for the Ev11
    kinds ct * the (3,) gradient of the sum in the Ev11 scalars (else
    None), for the inputs of fused_ll_fwd. ct is the 0-d cotangent on the
    card; nothing crosses to the host."""
    idx, n, k, mask_p, noise_p = _fused_ll_inputs(
        "fused likelihood backward", loc, scale, a, f, iobs, sig, mask,
        noise, ev, kind, ct)
    if ct.numel() != 1:
        raise ValueError(f"ct must hold one value; got {tuple(ct.shape)}")
    dev = loc.device
    grads = torch.empty((4, n), dtype=_F32, device=dev)
    dev_grad = part = None
    if kind.endswith("_ev11"):
        part = torch.empty((fused_ll_parts(n), 3), dtype=_F32, device=dev)
        dev_grad = torch.empty(3, dtype=_F32, device=dev)
    g = grads.data_ptr()
    err = _launch(library().ct_fused_ll_bwd, idx, loc.data_ptr(),
                  scale.data_ptr(), a.data_ptr(), f.data_ptr(),
                  iobs.data_ptr(), sig.data_ptr(), mask_p, noise_p,
                  ev.data_ptr(), ct.data_ptr(), g, g + 4 * n, g + 8 * n,
                  g + 12 * n, None if part is None else part.data_ptr(),
                  None if dev_grad is None else dev_grad.data_ptr(), n, k,
                  dof, t_const, seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                  offset)
    _check(err, "fused likelihood backward")
    LAUNCHES["fused_ll_bwd"] += 1
    dloc, dscale, da, df = grads.unbind(0)
    return dloc, dscale, da, df, dev_grad
