"""Scaling-MLP trunk, with or without its head: kernels K1-fwd/K1-bwd and
their plain versions.

Counterpart of careless_tpu/ops/fused_mlp.py (fused_mlp_trunk,
fused_mlp_trunk_head). For metadata x (N, d) and L hidden layers with
weights in the JAX layout (d_in, d_out):

    h_0 = x;  h_{l+1} = leaky_relu(h_l W_l + b_l)     fused_mlp_trunk: h_L
    (loc, raw) = h_L W_out + b_out                     fused_mlp_trunk_head

With bf16=True every layer product (the head's too) takes bf16 operands
and sums in f32, and its backward rounds the operands, not the results, of
its two products (`_dot` and `_bwd_kernel` there): dW = bf16(a)^T
bf16(dpre), dh = bf16(dpre) bf16(W)^T, db = sum dpre unrounded. That
backward is not autograd through the casts, which rounds each product's
result instead; the plain version spells it out (`_BF16Matmul`).

On the card the whole stack runs in one kernel per direction
(csrc/trunk.cu); the backward recomputes the forward and returns dW and db
(and dx only when x needs a gradient). On the CPU the plain version runs.
Lane packing (PackedMeta) was a TPU answer and is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

Layer = Dict[str, torch.Tensor]


def leaky_relu(h: torch.Tensor, leakiness: float) -> torch.Tensor:
    # slope 1 where h >= 0, as jax.nn.leaky_relu and the TPU kernel
    return torch.where(h >= 0, h, leakiness * h)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """The nearest bf16 value (ties to even), kept in f32."""
    return t.bfloat16().float()


class _BF16Matmul(torch.autograd.Function):
    """a @ b on bf16-rounded operands with f32 sums, and the backward of
    the TPU kernel: da = bf16(ct) bf16(b)^T, db = bf16(a)^T bf16(ct)."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        ct = round_bf16(ct)
        return (ct @ b.T if ctx.needs_input_grad[0] else None,
                a.T @ ct if ctx.needs_input_grad[1] else None)


def _dot(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    return _BF16Matmul.apply(a, b) if bf16 else a @ b


def plain_trunk(x: torch.Tensor, layers: Sequence[Layer], leakiness: float,
                bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the trunk-only K1: (N, width)."""
    h = x
    for layer in layers:
        h = leaky_relu(_dot(h, layer["w"], bf16) + layer["b"], leakiness)
    return h


def plain_trunk_head(x: torch.Tensor, layers: Sequence[Layer],
                     out_layer: Layer, leakiness: float, bf16: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1 with its head: flat (loc, raw)."""
    h = plain_trunk(x, layers, leakiness, bf16)
    y = _dot(h, out_layer["w"], bf16) + out_layer["b"]
    return y[:, 0], y[:, 1]


def pack_params(layers: Sequence[Layer], out_layer: Optional[Layer],
                kernel_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten the weights and biases into csrc/trunk.cu's layout, zero-
    padded from the model's width to the kernel's, with the head's when
    out_layer is given. Differentiable, so the kernel's dW/db flow back to
    each layer's tensors."""
    width = layers[0]["w"].shape[1]
    p = kernel_width - width
    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    for i, layer in enumerate(layers):
        ws.append(F.pad(layer["w"], (0, p, 0, 0 if i == 0 else p)))
        bs.append(F.pad(layer["b"], (0, p)))
    if out_layer is not None:
        ws.append(F.pad(out_layer["w"], (0, 0, 0, p)))
        bs.append(out_layer["b"])
    return (torch.cat([w.reshape(-1) for w in ws]),
            torch.cat([b.reshape(-1) for b in bs]))


class _Trunk(torch.autograd.Function):
    """K1 as one autograd node: (loc, raw) with the head, else (N, out_w)."""

    @staticmethod
    def forward(ctx, x, w, b, width, n_layers, leakiness, head, out_w,
                bf16):
        ctx.save_for_backward(x, w, b)
        ctx.cfg = (width, n_layers, leakiness, head, bf16)
        return kernels.trunk_fwd(x, w, b, width, n_layers, leakiness,
                                 head=head, out_w=out_w, bf16=bf16)

    @staticmethod
    def backward(ctx, *cts):
        x, w, b = ctx.saved_tensors
        width, n_layers, leakiness, head, bf16 = ctx.cfg
        n = x.shape[0]
        if head:
            dy = tuple(torch.zeros(n, dtype=x.dtype, device=x.device)
                       if ct is None else ct.contiguous() for ct in cts)
        else:
            dy = cts[0].contiguous()
        dw, db, dx = kernels.trunk_bwd(x, w, b, dy, width, n_layers,
                                       leakiness, ctx.needs_input_grad[0],
                                       head=head, bf16=bf16)
        return dx, dw, db, None, None, None, None, None, None


def fused_mlp_trunk(x: torch.Tensor, layers: Sequence[Layer],
                    leakiness: float, bf16: bool = False) -> torch.Tensor:
    """The hidden-layer stack over metadata x (N, d): (N, width)
    activations of the last layer. CPU tensors run the plain version; CUDA
    tensors run K1 (and K1-bwd in the backward) or raise."""
    if x.device.type == "cpu":
        return plain_trunk(x, layers, leakiness, bf16)
    width = layers[0]["w"].shape[1]
    kw = kernels.trunk_width(width)
    w, b = pack_params(layers, None, kw)
    return _Trunk.apply(x.contiguous(), w, b, kw, len(layers),
                        float(leakiness), False, width, bool(bf16))


def fused_mlp_trunk_head(x: torch.Tensor, layers: Sequence[Layer],
                         out_layer: Layer, leakiness: float,
                         bf16: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trunk + linear head over metadata x (N, d): flat (N,) (loc, raw).

    CPU tensors run the plain version; CUDA tensors run K1 (and K1-bwd in
    the backward) or raise."""
    if x.device.type == "cpu":
        return plain_trunk_head(x, layers, out_layer, leakiness, bf16)
    kw = kernels.trunk_width(layers[0]["w"].shape[1])
    w, b = pack_params(layers, out_layer, kw)
    return _Trunk.apply(x.contiguous(), w, b, kw, len(layers),
                        float(leakiness), True, None, bool(bf16))
