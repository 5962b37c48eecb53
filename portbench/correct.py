"""The comparison that decides `correct`: the port's first three steps
against the plain reference's.

Three numbers, each the worst over steps or leaves:

- loss_gap: |loss_port - loss_ref| / |loss_ref| over steps 1-3 (the loss
  each step reports, at the parameters it starts from);
- grad_gap: over the leaves, | |g_port| - |g_ref| | / max(|g_ref|, the
  median leaf's |g_ref|), of step 1's gradient as Adam takes it (the port's
  worked out from its first moment after one step, m / (1 - beta_1));
- change_gap: the same of the parameters' change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf with none moves under Adam by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

NAMES = ("loss_gap", "grad_gap", "change_gap")
# a leaf whose reference gradient norm is under this share of the median
# leaf's takes no part in change_gap
STILL_LEAF = 1e-3


def leaves(params, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict / list of tensors, dict keys
    sorted, lists in order: the order in which the merge hands its
    parameters to Adam."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in leaves(params[k], f"{prefix}{k}/")]
    if isinstance(params, (list, tuple)):
        return [x for i, v in enumerate(params)
                for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], params)]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _worst(port: Dict[str, float], ref: Dict[str, float]):
    """(the worst leaf's gap, that leaf)."""
    floor = statistics.median(ref.values())
    return max((abs(port[k] - ref[k]) / max(ref[k], floor, 1e-300), k)
               for k in ref)


def readings(port: dict, ref: dict, detail: bool = False) -> dict:
    """loss_gap, grad_gap and change_gap of `port` against `ref`, each a
    dict of losses (list), grads, params0 and params ({leaf: tensor});
    with `detail` also the worst leaf of each and each step's loss gap."""
    missing = set(ref["grads"]) ^ set(port["grads"])
    if missing:
        raise ValueError(f"the leaves differ: {sorted(missing)}")
    steps = [abs(a - b) / abs(b)
             for a, b in zip(port["losses"], ref["losses"])]
    loss_gap = (max(steps) if len(port["losses"]) == len(ref["losses"])
                else float("inf"))
    g_ref = {k: _norm(v) for k, v in ref["grads"].items()}
    g_port = {k: _norm(v) for k, v in port["grads"].items()}
    floor = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= STILL_LEAF * floor]
    d_ref = {k: _norm(ref["params"][k] - ref["params0"][k]) for k in moving}
    d_port = {k: _norm(port["params"][k].to(ref["params0"][k].device)
                       - port["params0"][k].to(ref["params0"][k].device))
              for k in moving}
    (grad_gap, grad_leaf), (change_gap, change_leaf) = (
        _worst(g_port, g_ref), _worst(d_port, d_ref))
    out = {k: (v if v == v else float("inf")) for k, v in
           dict(loss_gap=loss_gap, grad_gap=grad_gap,
                change_gap=change_gap).items()}
    if detail:
        out.update(loss_steps=steps, grad_leaf=grad_leaf,
                   change_leaf=change_leaf)
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in limits)
