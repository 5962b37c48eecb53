"""Parameter files of a merge (careless_tpu/utils/checkpoint.py:17-34).

save_params writes a parameter tree as one .npz whose keys are the tree's
paths joined by "/" (dict keys sorted, list indices), the keys that
jax.tree_util paths give the JAX package's tree of the same layout
(utils/params.py), so either package's files name the same leaves.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..models.merging.variational import flatten_params


def save_params(path: str, params: Any) -> None:
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays = {k: np.asarray(v.detach().cpu().numpy())
              for k, v in flatten_params(params)}
    np.savez(path, **arrays)
