"""The seeded synthetic merge problem, made with numpy from the seed.

A frozen copy of the generator the port's smoke script uses (itself the
JAX package's bench problem, rewritten in numpy): per observation a
reflection id, an image id, d standard-normal metadata columns, an
intensity drawn from a true amplitude and a true scale, and a fixed
uncertainty of 0.1. With `laue`, harmonic chains of 1-4 reflections over a
shuffled id table; each harmonic group is a prefix of one chain on one
image, its rows contiguous; the group-indexed intensities hold each group's
summed intensity, padded with 1.0 to the rows' length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Asu(NamedTuple):
    """The per-reflection arrays DataManager reads from an ASU collection."""
    centric: np.ndarray
    multiplicity: np.ndarray
    dHKL: np.ndarray


class Problem(NamedTuple):
    refl_id: np.ndarray       # (N,) int64
    image_id: np.ndarray      # (N,) int64
    file_id: np.ndarray       # (N,) zeros
    metadata: np.ndarray      # (N, d) float32
    intensities: np.ndarray   # (N,); Laue: per harmonic group, padded
    uncertainties: np.ndarray  # (N,) float32
    wavelength: Optional[np.ndarray]   # Laue only
    harmonic_id: Optional[np.ndarray]  # Laue only
    asu: Asu
    f_true: np.ndarray

    @property
    def n_obs(self) -> int:
        return len(self.refl_id)

    @property
    def arrays(self) -> tuple:
        """The row arrays in Inputs.from_arrays' order."""
        return (self.refl_id, self.image_id, self.file_id, self.metadata,
                self.intensities, self.uncertainties, self.wavelength,
                self.harmonic_id)


def build_problem(seed: int, n_obs: int, n_refl: int, n_images: int,
                  d_meta: int, laue: bool = False) -> Problem:
    rng = np.random.default_rng(seed)
    refl_id = rng.integers(0, n_refl, n_obs)
    image_id = rng.integers(0, n_images, n_obs)
    if laue:
        perm_ids = rng.permutation(n_refl).astype(np.int64)
        clens = rng.choice([1, 2, 3, 4], size=n_refl,
                           p=[0.5, 0.25, 0.15, 0.10])
        clens = clens[np.cumsum(clens) <= n_refl]
        rem = n_refl - int(clens.sum())
        if rem:
            clens = np.append(clens, rem)
        n_chains = len(clens)
        chain_start = np.concatenate([[0], np.cumsum(clens)[:-1]])
        # groups until the row budget is filled, trimmed at a group
        # boundary and topped up with singletons to land on n_obs
        est = int(n_obs / 1.4 * 1.05) + 8
        gc = rng.integers(0, n_chains, est)
        gl = 1 + (rng.random(est) * clens[gc]).astype(np.int64)
        k = int(np.searchsorted(np.cumsum(gl), n_obs, side="right"))
        gc, gl = gc[:k], gl[:k]
        fill = n_obs - (int(gl.sum()) if k else 0)
        if fill:
            gc = np.concatenate([gc, rng.integers(0, n_chains, fill)])
            gl = np.concatenate([gl, np.ones(fill, np.int64)])
        n_groups = len(gl)
        hid = np.repeat(np.arange(n_groups), gl)
        row_start = np.repeat(np.concatenate([[0], np.cumsum(gl)[:-1]]), gl)
        member = np.arange(n_obs) - row_start
        refl_id = perm_ids[np.repeat(chain_start[gc], gl) + member]
        image_id = rng.integers(0, n_images, n_groups)[hid]
    metadata = rng.normal(size=(n_obs, d_meta)).astype(np.float32)
    f_true = np.abs(rng.normal(1.0, 0.5, n_refl)) + 0.05
    scale_true = np.exp(0.2 * metadata[:, 0])
    iobs = scale_true * f_true[refl_id] ** 2
    iobs = iobs + 0.1 * np.sqrt(np.abs(iobs)) * rng.normal(size=n_obs)
    sig = np.full(n_obs, 0.1, np.float32)
    wavelength = hid_out = None
    if laue:
        grouped = np.zeros(n_groups, np.float32)
        np.add.at(grouped, hid, iobs.astype(np.float32))
        iobs = np.concatenate([grouped,
                               np.ones(n_obs - n_groups, np.float32)])
        wavelength, hid_out = np.ones(n_obs, np.float32), hid
    centric = rng.random(n_refl) < 0.2
    asu = Asu(centric=centric, multiplicity=np.ones(n_refl, np.float32),
              dHKL=np.ones(n_refl, np.float32))
    return Problem(refl_id, image_id, np.zeros(n_obs), metadata,
                   np.asarray(iobs, np.float32), sig, wavelength, hid_out,
                   asu, f_true)
