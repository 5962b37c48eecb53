"""Double-Wilson prior: a prior that couples related data sets.

Counterpart of careless_tpu/models/priors/double_wilson.py. Each input
file (ASU) may name a parent; a child's reflection follows a RiceWoolfson
distribution centred on r z_parent with scale sqrt(eps Sigma (1 - r^2))
(the variance halved for acentric reflections); roots, and children whose
reflection has no parent, follow the Wilson prior's root and Rice-Woolfson
at loc 0. Parent values are gathered through a table of cross-ASU
reflection ids (after an optional reindexing op), -1 where the parent ASU
lacks the reflection. With optimize_r, r is trained through a sigmoid
(params["prior"]["r_raw"], one per file).

The parameter protocol of the JAX package: init() gives params["prior"]
(empty unless r is trained), build(params) the distribution of this step,
whose metrics() are the rDW_<i> history columns. z may carry leading axes
(MC samples, the halves of the parallel crossvalidation); r may carry the
halves' axis before the file axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence
from warnings import warn

import numpy as np
import torch

from ...ops.distributions import RiceWoolfson
from .wilson import WilsonPrior


class _DoubleWilsonDist:
    """log_prob over the whole refl_id space for one r (..., n_files)."""

    def __init__(self, prior: "DoubleWilsonPrior", r: torch.Tensor):
        self.prior = prior
        self.r = r

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        p = self.prior
        r = self.r[..., p.asu_ids]                 # (..., n_refl)
        mask = p.reflids >= 0
        z_parent = torch.where(mask, z[..., torch.clamp(p.reflids, min=0)],
                               torch.zeros((), device=z.device))
        loc = torch.where(p.absent, torch.zeros((), device=z.device),
                          z_parent * r)
        r2 = torch.square(r)
        scale = torch.where(
            p.centric,
            torch.sqrt(p.multiplicity * p.sigma * (1.0 - r2)),
            torch.sqrt(0.5 * p.multiplicity * p.sigma * (1.0 - r2)))
        p_dw = RiceWoolfson(loc, scale, p.centric).log_prob(z)
        return torch.where(p.root, p.wilson_prior.log_prob(z), p_dw)

    def mean(self):
        return self.prior.wilson_prior.mean()

    def stddev(self):
        return self.prior.wilson_prior.stddev()

    def metrics(self) -> dict:
        return {f"rDW_{i}": self.r[..., i] for i in range(self.r.shape[-1])}


@dataclass(frozen=True, eq=False)
class DoubleWilsonPrior:
    centric: torch.Tensor       # (n_refl,) bool
    multiplicity: torch.Tensor  # (n_refl,) f32
    asu_ids: torch.Tensor       # (n_refl,) int64: each reflection's file
    reflids: torch.Tensor       # (n_refl,) int64: parent refl id or -1
    root: torch.Tensor          # (n_refl,) bool
    r_init: torch.Tensor        # (n_files,) f32
    sigma: object = 1.0         # Sigma, scalar or per reflection
    optimize_r: bool = False
    wilson_prior: Optional[WilsonPrior] = None

    @classmethod
    def from_asu_collection(cls, asu_collection, parents: Sequence,
                            r_values: Sequence[float],
                            reindexing_ops: Optional[Sequence] = None,
                            sigma=1.0, optimize_r: bool = False,
                            device=None) -> "DoubleWilsonPrior":
        """The parent table of each file's reflections (double_wilson.py:
        79-126): a root's own ids, a child's the ids of its Miller indices,
        reindexed by its op (a triplet string or an Op) and mapped to the
        parent's ASU, in the parent's ASU, -1 where missing."""
        from ...xtal.symop import Op

        reflids: List[np.ndarray] = []
        root: List[np.ndarray] = []
        for child, parent in enumerate(parents):
            child_asu = asu_collection.reciprocal_asus[child]
            n = len(child_asu)
            if parent is None:
                reflids.append(np.arange(n, dtype=np.int64)
                               + asu_collection.offsets[child])
                root.append(np.ones(n, dtype=bool))
                continue
            root.append(np.zeros(n, dtype=bool))
            parent_asu = asu_collection.reciprocal_asus[parent]
            h = child_asu.Hall
            if reindexing_ops is not None:
                op = reindexing_ops[child]
                if isinstance(op, str):
                    op = Op.from_xyz(op)
                h = op.apply_to_hkl(h)
            h, _ = parent_asu.spacegroup.map_to_asu(
                h, anomalous=parent_asu.anomalous)
            pid = np.full(len(h), parent, dtype=np.int64)
            reflids.append(asu_collection.to_refl_id(pid, h,
                                                     allow_missing=True))

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        sigma = (float(np.float32(sigma)) if np.isscalar(sigma)
                 else put(sigma, np.float32))
        centric = put(asu_collection.centric, bool)
        multiplicity = put(asu_collection.multiplicity, np.float32)
        return cls(centric=centric, multiplicity=multiplicity,
                   asu_ids=put(asu_collection.asu_ids, np.int64),
                   reflids=put(np.concatenate(reflids), np.int64),
                   root=put(np.concatenate(root), bool),
                   r_init=put(r_values, np.float32), sigma=sigma,
                   optimize_r=optimize_r,
                   wilson_prior=WilsonPrior(centric, multiplicity, sigma))

    @property
    def absent(self) -> torch.Tensor:
        return self.reflids < 0

    # ------------------------------------------------------- param protocol
    def init(self, device=None) -> dict:
        """{"r_raw": logit(r_init)} under optimize_r (r clipped to
        [1e-6, 1 - 1e-6] in f64 first, as the JAX package does), else {}."""
        if not self.optimize_r:
            return {}
        r = np.clip(self.r_init.cpu().numpy().astype(np.float64), 1e-6,
                    1 - 1e-6)
        return {"r_raw": torch.as_tensor(np.log(r / (1.0 - r)),
                                         dtype=torch.float32, device=device)}

    def build(self, params: dict) -> _DoubleWilsonDist:
        if self.optimize_r and "r_raw" in params:
            return _DoubleWilsonDist(self, torch.sigmoid(params["r_raw"]))
        return _DoubleWilsonDist(self, self.r_init)

    def mean(self):
        return self.wilson_prior.mean()

    def stddev(self):
        return self.wilson_prior.stddev()

    def log_prob(self, z):
        return self.build({}).log_prob(z)


def parse_parents(spec: str) -> List[Optional[int]]:
    return [None if i.strip() == "None" else int(i) for i in spec.split(",")]


def build_double_wilson_prior(dm, parser) -> DoubleWilsonPrior:
    """The prior of --double-wilson-parents, --double-wilson-r,
    --double-wilson-reindexing-ops, --optimize-double-wilson-r and
    --wilson-prior-b (double_wilson.py:159-178), on dm's device."""
    parents = parse_parents(parser.parents)
    r_values = [float(i) for i in parser.dwr.split(",")]
    for r in r_values:
        if (r >= 1.0) or (r <= -1.0):
            raise ValueError(
                f"Supplied --double-wilson-r value {r} outside of allowed "
                "range (-1, 1)")
        if r < 0:
            warn(f"Supplied --double-wilson-r value {r} is negative")
    sigma = dm.get_wilson_sigma(parser.wilson_prior_b)
    reindexing_ops = None
    if parser.reindexing_ops is not None:
        reindexing_ops = parser.reindexing_ops.split(";")
    return DoubleWilsonPrior.from_asu_collection(
        dm.asu_collection, parents, r_values, reindexing_ops, sigma=sigma,
        optimize_r=parser.optimize_double_wilson_r, device=dm.device)
