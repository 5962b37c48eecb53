"""Parameter files and training checkpoints of a merge
(careless_tpu/utils/checkpoint.py).

save_params writes a parameter tree as one .npz whose keys are the tree's
paths joined by "/" (dict keys sorted, list indices), the keys that
jax.tree_util paths give the JAX package's tree of the same layout
(utils/params.py), so either package's files name the same leaves.
load_params reads such a file, written by either package, into a tree of
the port's layout (the --scale-file and --structure-factor-file warm
start), with the JAX package's errors for a missing key or a wrong shape.

save_state and load_state hold a training checkpoint (--checkpoint-every,
--resume-from) in the JAX package's format, one .npz written atomically:
`params/<path>`; `__step__` (int64); `history/<metric>` (float64); and
optax's Adam state under its own key path (adam_prefix), `.count`
(int32) and `.mu`, `.nu`, each one f32 vector over all parameters in
flatten_params order (ravel_pytree's). The port also writes its random
state under keys the JAX package never reads: `rng/generator` (the
torch.Generator's get_state, uint8), `rng/device_type` and `rng/base`
(Trainer.train's 32-bit Philox base key).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.merging.variational import flatten_params


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, params: Any) -> None:
    arrays = {k: np.asarray(v.detach().cpu().numpy())
              for k, v in flatten_params(params)}
    np.savez(_npz(path), **arrays)


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return dict(data)


def _checked(stored: dict, key: str, path: str, shape) -> np.ndarray:
    """stored[key], with the JAX package's errors for a missing key or a
    wrong shape."""
    if key not in stored:
        raise KeyError(f"checkpoint {path} missing parameter {key}")
    arr = stored[key]
    if arr.shape != tuple(shape):
        raise ValueError(
            f"checkpoint {path} parameter {key} has shape {arr.shape}, "
            f"expected {tuple(shape)}")
    return arr


def load_params(path: str, like: Any) -> Any:
    """The tree of `like`'s structure with each leaf read from the file:
    shape-checked, with the dtype and device of `like`'s leaf."""
    path = _npz(path)
    stored = _read(path)
    loaded = {key: torch.as_tensor(_checked(stored, key, path, leaf.shape))
              .to(dtype=leaf.dtype, device=leaf.device)
              for key, leaf in flatten_params(like)}

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, path + (str(i),)) for i, v in enumerate(node)]
        return loaded["/".join(path)]
    return rebuild(like, ())


def adam_prefix(clipnorm=None, clipvalue=None, global_clipnorm=None) -> str:
    """The key path of optax's ScaleByAdamState in the JAX Trainer's
    optimizer (careless_tpu/models/merging/variational.py Trainer.optimizer):
    chain(per-leaf clipnorm if set, flatten(chain(clipvalue if set, global
    clipnorm if set, adam))), adam being chain(scale_by_adam, scale). The
    clips hold no state, so only the indices move."""
    outer = int(clipnorm is not None)
    inner = int(clipvalue is not None) + int(global_clipnorm is not None)
    return f"opt/{outer}/{inner}/0/"


class RngState(NamedTuple):
    """The port's random state in a checkpoint."""
    generator: torch.Tensor   # torch.Generator.get_state(), uint8
    device_type: str          # "cpu" or "cuda": the generator's kind
    base: int                 # Trainer.train's 32-bit Philox base key


def save_state(path: str, params: Any, optimizer: torch.optim.Adam,
               opt_prefix: str, step: int, history: dict,
               rng: Optional[RngState] = None) -> None:
    """Write a checkpoint: `params` (the tree whose leaves `optimizer`
    updates, in flatten_params order), the optimizer's Adam moments and
    step count (it has stepped) under `opt_prefix` (adam_prefix), `step`,
    `history`, and `rng`. Atomic: a temporary file then os.replace."""
    path = _npz(path)
    leaves = flatten_params(params)
    arrays = {"params/" + k: v.detach().cpu().numpy() for k, v in leaves}
    states = [optimizer.state[leaf] for _, leaf in leaves]
    arrays[opt_prefix + ".count"] = np.int32(int(states[0]["step"]))
    for suffix, key in ((".mu", "exp_avg"), (".nu", "exp_avg_sq")):
        arrays[opt_prefix + suffix] = torch.cat(
            [st[key].detach().reshape(-1) for st in states]
        ).to(torch.float32).cpu().numpy()
    arrays["__step__"] = np.int64(step)
    for k, v in history.items():
        arrays["history/" + k] = np.asarray(v, np.float64)
    if rng is not None:
        arrays["rng/generator"] = rng.generator.cpu().numpy()
        arrays["rng/device_type"] = np.asarray(rng.device_type)
        arrays["rng/base"] = np.uint32(rng.base)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, params: Any, optimizer: torch.optim.Adam,
               opt_prefix: str
               ) -> Tuple[int, Dict[str, List[float]], Optional[RngState]]:
    """Read a checkpoint written by either package into `params` (the tree
    whose leaves `optimizer` updates; overwritten in place) and into the
    optimizer's state (created for an optimizer that has not stepped:
    `step` a CPU f32 tensor, as torch.optim.Adam keeps it); returns
    (step, history, the port's random state or None). A file the JAX
    package wrote has no random state: the caller then draws its own, and
    its run cannot repeat the JAX run's draws (the two packages' random
    number generators differ). Shapes are checked with the JAX package's
    errors."""
    path = _npz(path)
    stored = _read(path)
    named = flatten_params(params)
    leaves = [leaf for _, leaf in named]
    with torch.no_grad():
        for key, leaf in named:
            leaf.copy_(torch.as_tensor(
                _checked(stored, "params/" + key, path, leaf.shape)))
    n = sum(leaf.numel() for leaf in leaves)
    count = int(_checked(stored, opt_prefix + ".count", path, ()))
    moments = [torch.as_tensor(_checked(stored, opt_prefix + m, path, (n,)))
               .split([leaf.numel() for leaf in leaves])
               for m in (".mu", ".nu")]
    for leaf, mu, nu in zip(leaves, *moments):
        optimizer.state[leaf] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.reshape(leaf.shape).to(
                device=leaf.device, dtype=leaf.dtype, copy=True),
            "exp_avg_sq": nu.reshape(leaf.shape).to(
                device=leaf.device, dtype=leaf.dtype, copy=True)}
    step = int(stored["__step__"])
    history = {k[len("history/"):]: stored[k].tolist()
               for k in stored if k.startswith("history/")}
    rng = None
    if "rng/generator" in stored:
        rng = RngState(torch.as_tensor(stored["rng/generator"]),
                       str(stored["rng/device_type"]),
                       int(stored["rng/base"]))
    return step, history, rng
