"""Variational merging model: the ELBO and the training loop.

Counterpart of careless_tpu/models/merging/variational.py for the mono
chain at one Monte Carlo sample (elbo, :179-234, with the MC KL of
_kl_terms, :570-585) and of its Trainer (:636-849):

    z_F   ~ q(F)                         (n_refl,)  truncated normal
    eps   ~ N(0, 1)                      (N,)       K3, Philox
    Sigma = loc + scale * eps            (N,)       scaler through K1 and K2
    Ipred = Sigma * z_F[refl_id]^2       (N,)       K2, planned gather
    loss  = -sum log p(Iobs | Ipred) + sum [log q(z_F) - log p(z_F)]

Parameters are a nested dict of tensors in the JAX package's layout
(utils/params.py converts between the two).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device, same_device
from ...ops.distributions import Normal
from ...ops.fused_elbo import prng_normal
from ...ops.plan_gather import plan_gather
from ..base import Inputs


@dataclass(frozen=True, eq=False)
class VariationalMergingModel:
    posterior: Any
    prior: Any
    likelihood: Any
    scaler: Any
    mc_samples: int = 1
    kl_weight: Optional[float] = None

    def __post_init__(self):
        if self.mc_samples != 1:
            raise NotImplementedError("--mc-samples other than 1")

    @property
    def metric_names(self) -> Tuple[str, ...]:
        return ("loss", "NLL", "F KLDiv")

    def elbo(self, params: dict, inputs: Inputs,
             generator: Optional[torch.Generator] = None, seed: int = 0,
             u_f: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Negative ELBO (the loss) and its metrics, one MC estimate.

        The reflection sample comes from standard uniforms u_f (drawn from
        `generator` when not given); the scale noise eps (when not given)
        from K3 with key `seed` and offset 0 (sample 0), whenever the scale
        distribution is a Normal."""
        if inputs.plans is None:
            raise ValueError("the ELBO needs gather plans (Inputs.with_plans)")
        q = self.posterior.distribution(params["posterior"])
        if u_f is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the uniforms u_f")
            u_f = torch.rand(q.loc.shape, generator=generator,
                             device=q.loc.device, dtype=torch.float32)
        z_f = q.sample_from_uniform(u_f)                     # (n_refl,)

        scale_dist = self.scaler.apply(params["scaler"], inputs)
        if not isinstance(scale_dist, Normal):
            raise TypeError("the mono chain expects a Normal scale "
                            f"distribution, got {type(scale_dist).__name__}")
        if eps is None:
            eps = prng_normal(inputs.n_obs, seed, 0, inputs.device)
        z_scale = scale_dist.loc + scale_dist.scale * eps
        z_obs = plan_gather(z_f, inputs.refl_id, inputs.plans.refl)
        ipred = z_scale * torch.square(z_obs)

        ll_total = torch.sum(self.likelihood.build(
            params.get("likelihood", {}), inputs).log_prob(ipred))

        kl_term = q.log_prob(z_f) - self.prior.log_prob(z_f)
        if self.kl_weight is None:
            nll = -ll_total
            kl = torch.sum(kl_term)
            loss = nll + kl
        else:
            nll = -ll_total / inputs.n_obs
            kl = torch.mean(kl_term)
            loss = nll + self.kl_weight * kl
        return loss, {"loss": loss, "NLL": nll, "F KLDiv": kl}


def flatten_params(params) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the JAX pytree order: dict keys sorted, lists
    in order."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))
    walk(params, ())
    return out


def map_params(fn, params):
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(fn, v) for v in params]
    return fn(params)


@dataclass(eq=False)
class Trainer:
    """Full-batch Adam with the reference's dynamics: the global gradient
    norm is recorded before the non-finite gradients are zeroed, the
    optional per-leaf / elementwise / global clips follow in optax's order,
    then Adam (eps 1e-7, the keras default). Metrics stay on the device and
    cross to the host once per chunk."""

    model: VariationalMergingModel
    learning_rate: float = 1e-3
    beta_1: float = 0.9
    beta_2: float = 0.99
    clipnorm: Optional[float] = None
    clipvalue: Optional[float] = None
    global_clipnorm: Optional[float] = None
    freeze: Tuple[str, ...] = ()

    @property
    def metric_keys(self) -> Tuple[str, ...]:
        return self.model.metric_names + ("Grad Norm",)

    def optimizer(self, leaves: List[torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(leaves, lr=self.learning_rate,
                                betas=(self.beta_1, self.beta_2), eps=1e-7)

    def transform_grads(self, grads: List[torch.Tensor],
                        frozen: List[bool]
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(updated grads, global norm): freeze, norm, zero non-finite,
        clipnorm per leaf, clipvalue, global clipnorm."""
        sizes = [g.numel() for g in grads]
        flat = torch.cat([torch.zeros_like(g).reshape(-1) if f
                          else g.reshape(-1) for g, f in zip(grads, frozen)])
        grad_norm = torch.sqrt(torch.sum(flat * flat))
        flat = torch.where(torch.isfinite(flat), flat, torch.zeros_like(flat))
        if self.clipnorm is not None:
            parts = []
            for g in flat.split(sizes):
                norm = torch.sqrt(torch.sum(g * g))
                parts.append(g * torch.clamp(
                    self.clipnorm / (norm + 1e-20), max=1.0))
            flat = torch.cat(parts)
        if self.clipvalue is not None:
            flat = torch.clamp(flat, -self.clipvalue, self.clipvalue)
        if self.global_clipnorm is not None:
            g_norm = torch.sqrt(torch.sum(flat * flat))
            flat = torch.where(g_norm < self.global_clipnorm, flat,
                               flat / g_norm * self.global_clipnorm)
        return ([g.view_as(ref) for g, ref in zip(flat.split(sizes), grads)],
                grad_norm)

    def train(self, params: dict, generator: torch.Generator,
              inputs: Inputs, steps: int, chunk_size: int = 100,
              device: DeviceLike = None) -> Tuple[dict, Dict[str, list]]:
        """Run `steps` full-batch steps on `device` (None: the card);
        returns (params, history).

        `generator` (on the inputs' device) draws the reflection samples and
        one 32-bit base key; the scale noise of step i uses the Philox key
        (base, i), so distinct steps draw from disjoint streams. The
        caller's params are not modified."""
        dev = resolve_device(device)
        if not (same_device(inputs.device, dev)
                and same_device(generator.device, dev)):
            raise ValueError(f"inputs ({inputs.device}) and generator "
                             f"({generator.device}) must be on {dev}")
        params = map_params(
            lambda t: t.detach().to(dev).clone().requires_grad_(True), params)
        named = flatten_params(params)
        leaves = [t for _, t in named]
        frozen = [path.split("/")[0] in self.freeze for path, _ in named]
        opt = self.optimizer(leaves)
        base = int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                                 device=generator.device).item())

        metric_keys = self.metric_keys
        history: Dict[str, list] = {k: [] for k in metric_keys}
        done = 0
        while done < steps:
            n = min(chunk_size, steps - done)
            rows = []
            for i in range(done, done + n):
                loss, metrics = self.model.elbo(params, inputs, generator,
                                                seed=base | (i << 32))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, leaves)]
                grads, grad_norm = self.transform_grads(grads, frozen)
                for p, g in zip(leaves, grads):
                    p.grad = g
                opt.step()
                metrics["Grad Norm"] = grad_norm
                rows.append(torch.stack(
                    [metrics[k].detach().reshape(()) for k in metric_keys]))
            chunk = torch.stack(rows).cpu()   # the one host sync per chunk
            for j, k in enumerate(metric_keys):
                history[k].extend(chunk[:, j].tolist())
            done += n
            bad = ~torch.isfinite(chunk[:, metric_keys.index("Grad Norm")])
            if bad.any():
                print("Encountered numerical issues, terminating "
                      "optimization early!")
                n_keep = done - n + int(torch.nonzero(bad)[0]) + 1
                for k in history:
                    history[k] = history[k][:n_keep]
                break
        return map_params(lambda t: t.detach(), params), history
