"""Parameter files of a merge (careless_tpu/utils/checkpoint.py:17-34 and
71-99).

save_params writes a parameter tree as one .npz whose keys are the tree's
paths joined by "/" (dict keys sorted, list indices), the keys that
jax.tree_util paths give the JAX package's tree of the same layout
(utils/params.py), so either package's files name the same leaves.
load_params reads such a file, written by either package, into a tree of
the port's layout (the --scale-file and --structure-factor-file warm
start), with the JAX package's errors for a missing key or a wrong shape.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.merging.variational import flatten_params


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, params: Any) -> None:
    arrays = {k: np.asarray(v.detach().cpu().numpy())
              for k, v in flatten_params(params)}
    np.savez(_npz(path), **arrays)


def load_params(path: str, like: Any) -> Any:
    """The tree of `like`'s structure with each leaf read from the file:
    shape-checked, with the dtype and device of `like`'s leaf."""
    path = _npz(path)
    with np.load(path) as data:
        stored = dict(data)
    loaded = {}
    for key, leaf in flatten_params(like):
        if key not in stored:
            raise KeyError(f"checkpoint {path} missing parameter {key}")
        arr = stored[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint {path} parameter {key} has shape {arr.shape}, "
                f"expected {tuple(leaf.shape)}")
        loaded[key] = torch.as_tensor(arr).to(dtype=leaf.dtype,
                                              device=leaf.device)

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, path + (str(i),)) for i, v in enumerate(node)]
        return loaded["/".join(path)]
    return rebuild(like, ())
