"""Scaling-MLP trunk + head: kernels K1-fwd/K1-bwd and their plain version.

Counterpart of careless_tpu/ops/fused_mlp.py (fused_mlp_trunk_head). For
metadata x (N, d) and L hidden layers with weights in the JAX layout
(d_in, d_out), it returns flat (N,) loc and raw scale:

    h_0 = x;  h_{l+1} = leaky_relu(h_l W_l + b_l);  (loc, raw) = h_L W_out + b_out

On the card the whole stack runs in one kernel per direction
(csrc/trunk.cu); the backward recomputes the forward and returns dW and db
(and dx only when x needs a gradient). On the CPU the plain version runs
and autograd differentiates it. Lane packing (PackedMeta) was a TPU answer
and is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

Layer = Dict[str, torch.Tensor]


def _leaky(h: torch.Tensor, leakiness: float) -> torch.Tensor:
    # slope 1 where h >= 0, as jax.nn.leaky_relu and the TPU kernel
    return torch.where(h >= 0, h, leakiness * h)


def plain_trunk_head(x: torch.Tensor, layers: Sequence[Layer],
                     out_layer: Layer, leakiness: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1 (f32 matmuls)."""
    h = x
    for layer in layers:
        h = _leaky(h @ layer["w"] + layer["b"], leakiness)
    y = h @ out_layer["w"] + out_layer["b"]
    return y[:, 0], y[:, 1]


def pack_params(layers: Sequence[Layer], out_layer: Layer, kernel_width: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten the weights and biases into csrc/trunk.cu's layout, zero-
    padded from the model's width to the kernel's. Differentiable, so the
    kernel's dW/db flow back to each layer's tensors."""
    width = layers[0]["w"].shape[1]
    p = kernel_width - width
    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    for i, layer in enumerate(layers):
        ws.append(F.pad(layer["w"], (0, p, 0, 0 if i == 0 else p)))
        bs.append(F.pad(layer["b"], (0, p)))
    ws.append(F.pad(out_layer["w"], (0, 0, 0, p)))
    bs.append(out_layer["b"])
    return (torch.cat([w.reshape(-1) for w in ws]),
            torch.cat([b.reshape(-1) for b in bs]))


class _TrunkHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, width, n_layers, leakiness):
        loc, raw = kernels.trunk_fwd(x, w, b, width, n_layers, leakiness)
        ctx.save_for_backward(x, w, b)
        ctx.shape = (width, n_layers, leakiness)
        return loc, raw

    @staticmethod
    def backward(ctx, dloc, draw):
        x, w, b = ctx.saved_tensors
        width, n_layers, leakiness = ctx.shape
        dloc = (torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
                if dloc is None else dloc.contiguous())
        draw = (torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
                if draw is None else draw.contiguous())
        dw, db, dx = kernels.trunk_bwd(x, w, b, dloc, draw, width, n_layers,
                                       leakiness, ctx.needs_input_grad[0])
        return dx, dw, db, None, None, None


def fused_mlp_trunk_head(x: torch.Tensor, layers: Sequence[Layer],
                         out_layer: Layer, leakiness: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trunk + linear head over metadata x (N, d): flat (N,) (loc, raw).

    CPU tensors run the plain version; CUDA tensors run K1 (and K1-bwd in
    the backward) or raise."""
    if x.device.type == "cpu":
        return plain_trunk_head(x, layers, out_layer, leakiness)
    if len(layers) < 1:
        raise ValueError("the trunk kernel needs at least one hidden layer")
    kw = kernels.trunk_width(layers[0]["w"].shape[1])
    w, b = pack_params(layers, out_layer, kw)
    return _TrunkHead.apply(x.contiguous(), w, b, kw, len(layers),
                            float(leakiness))
