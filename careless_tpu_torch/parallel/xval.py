"""Half-dataset crossvalidation as one merge: the parallel form of
--merge-half-datasets (--xval-mode=parallel, the default).

Counterpart of careless_tpu/parallel/xval.py, which vmaps K = 2 x
--half-dataset-repeats copies of the training loop over padded, stacked
halves. On the card a step is host-bound (one merge's launches cost more
than its kernels), so K merges run one after another cost about K merges'
launches; here every step is one pass over all K halves instead:

- stack_halves lays half k's planned rows end to end, its refl_id offset
  by k n_refl into one stacked posterior of K n_refl reflections and, for
  Laue, its harmonic ids offset by its first row, so that its group table
  lies in its own rows. image_id stays: the frozen scaler is shared. The
  plans are built once over the concatenation at (K n_refl, n_images):
  mono rows stay sorted, and Laue's halves, each in its own chain layout,
  are together the chain layout of the stacked table. The refl plan's
  segment sum is blocked (ops/plan_gather.py block_plan): each half's
  cotangent starts at a chunk of its own, so that its local prefix sums
  are its serial run's.
- Every leaf outside the frozen subtrees gets a leading axis of K (the
  posterior (K, n_refl)); Adam is elementwise, so one Adam over them is K
  Adams. The frozen scaler runs once a step over all rows (one K1-fwd, no
  K1-bwd), and each K2 gather once, as in one merge.
- Each half computes what its serial run computes (halves_elbo): its NLL
  over its own rows and samples, its KL over its own slice of the table,
  its noise from its own generator (the base key, then the uniforms each
  step, as Trainer.train draws them) and its own Philox key (K3 once per
  half, at offset 0; K4 once per half and sample under the fused policy),
  its own likelihood and prior parameters, and its own gradient norm,
  non-finite zeroing and clips (Trainer.transform_grads, batched). The
  loss that is differentiated is the sum of the K losses.
- Nothing in the step sums across halves: each half's loss, gradient norm
  and clips are its own, and the blocked segment sum keeps each half's
  chunk sums and prefixes apart. So a non-finite entry stays in its half:
  that half's Grad Norm reads NaN for the step (transform_grads takes it
  before zeroing the entry), the others train on, and the bad halves are
  reported at the end, as the JAX package reports them
  (parallel/xval.py:168-187).

Each half's sums are taken in its serial run's order, so the parallel
form equals the serial form bit for bit, save where a clip's norm or the
Ev11 scalars' gradient sums a half's terms in another grouping (f32
rounding).

Over several ranks (train_halves_spread) each rank trains K / W of the
halves as one such merge and the ranks then exchange what they trained;
no step needs a collective, since nothing sums across halves
(careless_tpu/parallel/xval.py:130-139). When W does not divide K, rank 0
trains them all, as the JAX package then shards nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from . import distributed
from ..models.base import Inputs
from ..models.merging.variational import flatten_params, map_params
from ..models.scaling.image import HybridImageScaler
from ..ops.fused_elbo import fused_likelihood_sum_gathered, prng_normal
from ..ops.plan_gather import ChainGatherPlan, block_plan, plan_gather

# the serial loop's seed stride (careless_tpu/main.py:198)
SEED_STRIDE = 7919


@dataclass(frozen=True, eq=False)
class StackedHalves:
    """K halves' planned rows end to end, with plans over them."""
    inputs: Inputs             # plans at (K n_refl, n_images)
    bounds: Tuple[int, ...]    # half k holds rows bounds[k]:bounds[k + 1]
    n_refl: int                # one half's table

    @property
    def k(self) -> int:
        return len(self.bounds) - 1

    @property
    def spans(self) -> List[Tuple[int, int]]:
        return list(zip(self.bounds[:-1], self.bounds[1:]))


def stack_halves(halves: Sequence[Inputs], n_refl: int,
                 n_images: int) -> StackedHalves:
    """The StackedHalves of each half's planned rows
    (DataManager.planned_rows(half).inputs), in order."""
    bounds = np.cumsum([0] + [h.n_obs for h in halves]).tolist()

    def cat(name, shift=None):
        parts = [getattr(h, name) for h in halves]
        if parts[0] is None:
            return None
        if shift is not None:
            parts = [p + shift(k) for k, p in enumerate(parts)]
        return torch.cat(parts)

    stacked = Inputs(
        refl_id=cat("refl_id", lambda k: k * n_refl),
        image_id=cat("image_id"), file_id=cat("file_id"),
        metadata=cat("metadata"), intensities=cat("intensities"),
        uncertainties=cat("uncertainties"), wavelength=cat("wavelength"),
        harmonic_id=cat("harmonic_id", lambda k: bounds[k]))
    stacked = stacked.with_plans(len(halves) * n_refl, n_images)
    plans = stacked.plans
    refl = plans.refl
    if isinstance(refl, ChainGatherPlan):
        refl = dataclasses.replace(refl, inner=block_plan(refl.inner, bounds))
    else:
        refl = block_plan(refl, bounds)
    return StackedHalves(
        stacked.replace(plans=dataclasses.replace(plans, refl=refl)),
        tuple(bounds), n_refl)


def make_half_keys(seed: int, repeats: int) -> List[int]:
    """Each half's generator seed, the serial loop's seed + 7919 (2 repeat
    + half + 1), in the order the halves are split."""
    return [seed + SEED_STRIDE * (2 * repeat + half + 1)
            for repeat in range(repeats) for half in range(2)]


def _per_row(params: dict, spans) -> dict:
    """Each half's likelihood parameters (K,) repeated over its rows."""
    return {k: torch.cat([v[i].expand(b - a) for i, (a, b)
                          in enumerate(spans)]) for k, v in params.items()}


def _ll_rows(likelihood, ipred: torch.Tensor) -> torch.Tensor:
    """The terms of VariationalMergingModel._masked_ll_sum by row."""
    if hasattr(likelihood, "masked_ll_rows"):
        return likelihood.masked_ll_rows(ipred)
    return likelihood.log_prob(ipred)


def halves_elbo(model, params: dict, halves: StackedHalves,
                u_f: torch.Tensor, seeds: Sequence[int],
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss (K,), metrics of (K,)): each half's model.elbo with its
    reflection noise u_f[..., k, :] (the truncated normal's uniforms
    (S, K, n_refl)) and its Philox key
    seeds[k], or the scale noise eps (S, N) over the stacked rows when
    given (the unfused path); params as train_halves holds them."""
    inputs, spans, S, K = halves.inputs, halves.spans, model.mc_samples, \
        halves.k
    dev = inputs.device
    q = model.posterior.distribution(params["posterior"])  # (K, n_refl)
    z_f = q.sample_from_noise(u_f)                          # (S, K, n_refl)
    z_tab = z_f.reshape(S, K * halves.n_refl)
    plans = inputs.plans
    lik_params = params.get("likelihood", {})
    if model._fused_eligible(inputs):
        scaler = model.scaler
        if isinstance(scaler, HybridImageScaler):
            mlp_dist = scaler.mlp.apply(params["scaler"]["mlp"], inputs)
            image_scales = scaler.image.scales(params["scaler"]["image"])
        else:
            mlp_dist = scaler.apply(params["scaler"], inputs)
            image_scales = torch.ones(1, device=dev)
        kind, dof = model._fused_likelihood_kind()
        ev11 = [model._fused_ev11_scalars(
            kind, {name: v[k] for name, v in lik_params.items()})
            for k in range(K)]
        parts = [[] for _ in range(K)]
        for s in range(S):
            if image_scales.shape[0] > 1:
                a_obs = plan_gather(image_scales, inputs.image_id,
                                    plans.image)
            else:
                a_obs = image_scales.expand(inputs.n_obs)
            f_obs = plan_gather(z_tab[s], inputs.refl_id, plans.refl)
            for k, (a, b) in enumerate(spans):
                parts[k].append(fused_likelihood_sum_gathered(
                    mlp_dist.loc[a:b], mlp_dist.scale[a:b], a_obs[a:b],
                    f_obs[a:b], inputs.intensities[a:b],
                    inputs.uncertainties[a:b], seed=seeds[k],
                    offset=s * (b - a), kind=kind, dof=dof, ev11=ev11[k]))
        ll = torch.stack([sum(p[1:], p[0]) for p in parts])
    else:
        scale_dist = model.scaler.apply(params["scaler"], inputs)
        if eps is None:
            eps = torch.cat([prng_normal(S * (b - a), seed, 0, dev).view(
                S, b - a) for (a, b), seed in zip(spans, seeds)], dim=1)
        likelihood = model.likelihood.build(_per_row(lik_params, spans),
                                            inputs)
        rows = 0.0
        for s in range(S):
            z_scale = scale_dist.loc + scale_dist.scale * eps[s]
            z_obs = plan_gather(z_tab[s], inputs.refl_id, plans.refl)
            rows = rows + _ll_rows(likelihood, z_scale * torch.square(z_obs))
        ll = torch.stack([rows[a:b].sum() for a, b in spans])
    n_obs = torch.tensor([b - a for a, b in spans], dtype=torch.float32,
                         device=dev)
    loss, metrics = model._loss(q, z_f, ll, n_obs, model._built_prior(params))
    return loss, {k: torch.broadcast_to(v, (K,)) for k, v in metrics.items()}


def train_halves(trainer, params: dict, seeds: Sequence[int],
                 halves: StackedHalves, steps: int, chunk_size: int = 100,
                 device: DeviceLike = None
                 ) -> Tuple[dict, Dict[str, list]]:
    """Train halves.k merges of `trainer.model`, one per half, each from
    `params` and a generator seeded with seeds[k], `steps` full-batch
    steps: (the trained tree, in which every leaf outside trainer.freeze
    has a leading axis of K; each metric's history, a list of K values a
    step). The halves whose gradient norm was ever non-finite are
    reported. Metrics cross to the host once per chunk."""
    dev = resolve_device(device)
    model, K, S = trainer.model, halves.k, trainer.model.mc_samples
    if len(seeds) != K:
        raise ValueError(f"{len(seeds)} seeds for {K} halves")
    gens = [seeded_generator(seed, dev) for seed in seeds]
    bases = [int(torch.randint(0, 2 ** 32, (1,), generator=g,
                               device=dev).item()) for g in gens]

    def stacked(t):
        t = t.detach().to(dev)
        return t.expand((K,) + tuple(t.shape)).clone().requires_grad_(True)

    params = {name: map_params(
        (lambda t: t.detach().to(dev)) if name in trainer.freeze
        else stacked, sub) for name, sub in params.items()}
    leaves = [t for path, t in flatten_params(params)
              if path.split("/")[0] not in trainer.freeze]
    opt = trainer.optimizer(leaves)
    keys = trainer.metric_keys
    history: Dict[str, list] = {k: [] for k in keys}
    done = 0
    while done < steps:
        n = min(chunk_size, steps - done)
        rows = []
        for i in range(done, done + n):
            u_f = torch.stack([model.posterior.family.draw_noise(
                g, (S, halves.n_refl), dev) for g in gens], dim=-2)
            loss, metrics = halves_elbo(model, params, halves, u_f,
                                        [b | (i << 32) for b in bases])
            grads = trainer.gradients(loss.sum(), leaves,
                                      [False] * len(leaves))
            grads, metrics["Grad Norm"] = trainer.transform_grads(
                grads, [False] * len(leaves), batched=True)
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            rows.append(torch.stack([metrics[k].detach() for k in keys]))
        chunk = torch.stack(rows).cpu()   # (n, metrics, K): one host sync
        for j, k in enumerate(keys):
            history[k].extend(chunk[:, j].tolist())
        done += n
    norms = np.asarray(history["Grad Norm"]).reshape(-1, K)
    bad = np.flatnonzero(~np.isfinite(norms).all(axis=0)).tolist()
    if bad:
        print("Encountered numerical issues in crossvalidation half(s) "
              f"{bad} (NaN grads were zeroed; those halves may be "
              "degraded)")
    return map_params(lambda t: t.detach(), params), history


def halves_of_rank(k: int) -> range:
    """The halves this rank trains of k spread over the ranks: [r k / W,
    (r + 1) k / W), or all k on rank 0 (none elsewhere) where W does not
    divide k."""
    world, rank = distributed.world_size(), distributed.rank()
    if k % world == 0:
        per = k // world
        return range(rank * per, (rank + 1) * per)
    return range(k) if rank == 0 else range(0)


def gather_halves(trainer, params: dict, part,
                  device: DeviceLike = None
                  ) -> Tuple[dict, Dict[str, list]]:
    """Every rank's train_halves result `part` (None where it trained no
    half) put together in half order on every rank: the tree with a
    leading axis of all the halves outside trainer.freeze (those subtrees
    from `params`), on `device`, and each metric's history of a value per
    half a step."""
    dev = resolve_device(device)
    if distributed.world_size() == 1:
        return part
    if part is not None:
        tree, history = part
        part = ({name: map_params(lambda t: t.cpu(), sub)
                 for name, sub in tree.items()
                 if name not in trainer.freeze}, history)
    parts = [p for p in distributed.all_gather_object(part)
             if p is not None]
    out = {name: map_params(lambda t: t.detach().to(dev), sub)
           for name, sub in params.items() if name in trainer.freeze}
    for name in parts[0][0]:
        leaves = [flatten_params(p[0][name]) for p in parts]
        out[name] = _rebuild(parts[0][0][name], {
            path: torch.cat([ls[i][1] for ls in leaves]).to(dev)
            for i, (path, _) in enumerate(leaves[0])})
    history = {key: [sum((p[1][key][i] for p in parts), [])
                     for i in range(len(parts[0][1][key]))]
               for key in parts[0][1]}
    return out, history


def train_halves_spread(trainer, params: dict, seeds: Sequence[int],
                        halves: Sequence[Inputs], n_refl: int, n_images: int,
                        steps: int, chunk_size: int = 100,
                        device: DeviceLike = None
                        ) -> Tuple[dict, Dict[str, list]]:
    """train_halves of the planned rows `halves` (DataManager.planned_rows
    of each half, in order) spread over the ranks of the process group
    (one rank without one): each rank stacks and trains its
    halves_of_rank, and every rank returns gather_halves' whole. Each half
    trains as it does in one process, so the result is train_halves' of
    all the halves from the same params."""
    mine = halves_of_rank(len(halves))
    part = None
    if len(mine):
        stacked = stack_halves([halves[k] for k in mine], n_refl, n_images)
        part = train_halves(trainer, params, [seeds[k] for k in mine],
                            stacked, steps, chunk_size, device)
    return gather_halves(trainer, params, part, device)


def _rebuild(tree, leaves: Dict[str, torch.Tensor]):
    """`tree` with each leaf replaced by leaves[its flatten_params
    path]."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return leaves["/".join(path)]
    return walk(tree, ())


def half_params(params: dict, k: int, frozen: Sequence[str]) -> dict:
    """Half k's parameters from train_halves' tree."""
    return {name: sub if name in frozen
            else map_params(lambda t: t[k], sub)
            for name, sub in params.items()}
