"""The row layout the merge trains on, worked out from the problem arrays.

The scale noise of row i of the layout is Philox index i, so the layout
decides which noise each observation gets. Mono: the rows stably sorted by
reflection id. Laue: the harmonic-chain layout, a frozen copy of the
port's host algorithm: reflections renumbered so that each harmonic chain
(a connected component of the group co-occurrence graph) holds consecutive
ids, groups ordered by their least renumbered id (ties by group id), rows
within a group by renumbered id.
"""
from __future__ import annotations

import numpy as np


def mono_order(refl_id) -> np.ndarray:
    return np.argsort(np.asarray(refl_id), kind="stable")


def chain_labels(refl_id, harmonic_id, n_refl: int) -> np.ndarray:
    """Each reflection's least refl_id in its chain, by label propagation
    with pointer jumping."""
    rid = np.asarray(refl_id, np.int64).reshape(-1)
    hid = np.asarray(harmonic_id, np.int64).reshape(-1)
    lab = np.arange(n_refl, dtype=np.int64)
    if len(rid) == 0:
        return lab
    order = np.lexsort((rid, hid))
    r, h = rid[order], hid[order]
    same = h[1:] == h[:-1]
    a, b = r[:-1][same], r[1:][same]
    if len(a) == 0:
        return lab
    while True:
        m = np.minimum(lab[a], lab[b])
        new = lab.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = np.minimum(new, new[new])
        if np.array_equal(new, lab):
            return lab
        lab = new


def chain_order(refl_id, harmonic_id, n_refl: int) -> np.ndarray:
    rid = np.asarray(refl_id).reshape(-1)
    hid = np.asarray(harmonic_id, np.int64).reshape(-1)
    lab = chain_labels(rid, hid, n_refl)
    sigma = np.lexsort((np.arange(n_refl), lab))
    sigma_inv = np.empty(n_refl, np.int64)
    sigma_inv[sigma] = np.arange(n_refl)
    local = sigma_inv[rid]
    n_groups = int(hid.max()) + 1 if len(hid) else 0
    gmin = np.full(n_groups, np.iinfo(np.int64).max)
    np.minimum.at(gmin, hid, local)
    return np.lexsort((local, hid, gmin[hid]))


def row_order(problem) -> np.ndarray:
    """The original row of each row of the layout."""
    if problem.harmonic_id is None:
        return mono_order(problem.refl_id)
    return chain_order(problem.refl_id, problem.harmonic_id,
                       len(problem.asu.centric))
