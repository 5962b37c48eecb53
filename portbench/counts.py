"""Operations and bytes of the scaler MLP's kernels (K1), of the planned
gathers (K2, K5) and of a whole step, counted from shapes.

K1 counts the multiply-adds of its products (2 operations each; bias adds
and the leaky ReLU are left out), reads its inputs and writes its outputs
once. Its backward recomputes the forward, then takes dh (to the first
layer's input only where dx is asked for) and dW. A gather reads each of
its ids, writes each output once, and reads at most as many table entries
as it has ids (never more than the table holds).
"""
from __future__ import annotations

F32 = 4


def trunk_fwd_flops_per_row(d_in: int, width: int, n_layers: int,
                            head: bool = True, out_w: int = 2) -> int:
    hidden = d_in * width + (n_layers - 1) * width * width
    return 2 * (hidden + (width * out_w if head else 0))


def trunk_fwd(n: int, d_in: int, width: int, n_layers: int,
              head: bool = True, out_w: int = 2):
    """(operations, bytes) of one K1 forward over n rows."""
    weights = d_in * width + (n_layers - 1) * width * width \
        + n_layers * width + ((width + 1) * 2 if head else 0)
    outs = 2 if head else out_w
    flops = n * trunk_fwd_flops_per_row(d_in, width, n_layers, head)
    return flops, F32 * (n * d_in + n * outs + weights)


def trunk_bwd(n: int, d_in: int, width: int, n_layers: int,
              head: bool = True, need_dx: bool = False, out_w: int = 2):
    """(operations, bytes) of one K1 backward over n rows: the recomputed
    forward, dh, dW; it reads x, the cotangent and the weights, and writes
    dW, db (and dx)."""
    fwd = trunk_fwd_flops_per_row(d_in, width, n_layers, head)
    dh = fwd - (0 if need_dx else 2 * d_in * width)
    weights = d_in * width + (n_layers - 1) * width * width \
        + n_layers * width + ((width + 1) * 2 if head else 0)
    outs = 2 if head else out_w
    nbytes = F32 * (n * d_in + n * outs + 2 * weights
                    + (n * d_in if need_dx else 0))
    return n * (2 * fwd + dh), nbytes


def gather(n_ids: int, table: int):
    """(operations, bytes) of out[k] = table[ids[k]] over n_ids ids."""
    return 0, F32 * (2 * n_ids + min(n_ids, table))


def model_flops_per_step(n: int, d_in: int, width: int,
                         n_layers: int) -> int:
    """The scaler MLP's model FLOPs a step: its forward over every row and
    twice that for the backward (no recompute); the MLP runs once a step
    whatever the samples."""
    return 3 * n * trunk_fwd_flops_per_row(d_in, width, n_layers)
