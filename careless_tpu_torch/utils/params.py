"""Parameters between the JAX package's layout and the port's.

The port keeps the JAX package's parameter tree as nested dicts and lists
of tensors, with dense weights (d_in, d_out): posterior.{loc_raw,
scale_raw}, scaler.mlp.layers[i].{w, b}, scaler.mlp.out.{w, b},
scaler.image.scales, the --image-layers banks
scaler.image_layers[i].{w (max_images, width, width), b (max_images,
width)} and, for the Ev11 likelihoods, the 0-d leaves
likelihood.{sdfac_raw, sdadd_raw, sdb_raw}. A JAX tree exported as numpy
arrays (for example with jax.tree.map(np.asarray, params)) converts leaf
for leaf, so both packages compute the same thing from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.merging.variational import map_params


def params_from_jax(tree, device) -> dict:
    """Nested dicts/lists of numpy arrays -> the same tree of f32 tensors."""
    return map_params(
        lambda a: torch.as_tensor(np.array(a, dtype=np.float32),
                                  device=device), tree)


def params_to_numpy(params) -> dict:
    """The port's parameter tree -> the same tree of numpy arrays."""
    return map_params(lambda t: t.detach().cpu().numpy(), params)
