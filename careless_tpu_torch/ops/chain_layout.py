"""Harmonic-chain reflection renumbering: the Laue training layout.

Counterpart of careless_tpu/ops/chain_layout.py, copied (the port imports
nothing of the JAX package). Every harmonic group's reflections lie on one
central ray, so the reflection co-occurrence graph splits into tiny chains
(its connected components). Reflections are renumbered so that each chain's
members hold consecutive ids, groups are ordered by their least renumbered
id and rows within a group by renumbered id. Then the refl gather's ids are
sorted up to a displacement bounded by one chain's observation count, and
the backward permute to id order is a quasi-identity permutation with tight
per-tile windows (ops/plan_gather.py, ChainGatherPlan).

Host numpy, once per data set. The results must equal the JAX package's
exactly: row order decides which noise each row gets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def chain_labels(refl_id, harmonic_id, n_refl: int) -> np.ndarray:
    """Label every reflection with the least refl_id of its harmonic chain
    (the connected component of the group co-occurrence graph), by label
    propagation with pointer jumping."""
    rid = np.asarray(refl_id, np.int64).reshape(-1)
    hid = np.asarray(harmonic_id, np.int64).reshape(-1)
    lab = np.arange(n_refl, dtype=np.int64)
    if len(rid) == 0:
        return lab
    order = np.lexsort((rid, hid))
    r, h = rid[order], hid[order]
    same = h[1:] == h[:-1]
    a, b = r[:-1][same], r[1:][same]  # co-occurrence edges (within groups)
    if len(a) == 0:
        return lab
    while True:
        m = np.minimum(lab[a], lab[b])
        new = lab.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = np.minimum(new, new[new])  # pointer jump
        if np.array_equal(new, lab):
            return lab
        lab = new


def chain_permutation(refl_id, harmonic_id, n_refl: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(sigma, sigma_inv): sigma[new_id] = old_id orders reflections by
    (chain label, old id); sigma_inv is its inverse (old -> new). It
    depends on the data only, not on the row order."""
    lab = chain_labels(refl_id, harmonic_id, n_refl)
    sigma = np.lexsort((np.arange(n_refl), lab)).astype(np.int32)
    sigma_inv = np.empty(n_refl, np.int32)
    sigma_inv[sigma] = np.arange(n_refl, dtype=np.int32)
    return sigma, sigma_inv


def chain_row_order(refl_id, harmonic_id, n_refl: int) -> np.ndarray:
    """Row permutation of the chain layout: groups stay contiguous, ordered
    by their least renumbered refl id (ties by group id), rows within a
    group by renumbered id."""
    rid = np.asarray(refl_id).reshape(-1)
    hid = np.asarray(harmonic_id, np.int64).reshape(-1)
    _, sigma_inv = chain_permutation(rid, hid, n_refl)
    local = sigma_inv[rid]
    n_groups = int(hid.max()) + 1 if len(hid) else 0
    gmin = np.full(n_groups, np.iinfo(np.int64).max)
    np.minimum.at(gmin, hid, local.astype(np.int64))
    return np.lexsort((local, hid, gmin[hid]))
