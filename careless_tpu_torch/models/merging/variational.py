"""Variational merging model: the ELBO and the training loop.

Counterpart of careless_tpu/models/merging/variational.py for the mono
and Laue chains with S = mc_samples Monte Carlo samples (elbo, :179-234;
_elbo_fused, :236-300; the prior's parameter protocol, :150-175; the MC
and the analytic KL of _kl_terms, :570-585) and of its Trainer
(:636-849):

    z_F   ~ q(F)                         (S, n_refl)  the surrogate posterior
    eps   ~ N(0, 1)                      (S, N)       Philox (K3, or in K4)
    Sigma = loc + scale * eps            (S, N)       scaler through K1, K2
    Ipred = Sigma * z_F[refl_id]^2       (S, N)       K2, planned gather
    loss  = -sum log p(Iobs | Ipred) / S + sum [log q(z_F) - log p(z_F)] / S

With analytic_kl (--analytic-kl) and a prior that has expected_log_prob
(the Wilson prior) the KL is -H(q) - E_q[log p], closed form but for the
acentric E[log z], which averages the samples' log z. A prior with a
`build` (double-Wilson) is built from params["prior"] each step and adds
its metrics (rDW_<i>) to the history.

With fused_kernel (and a fused-supported likelihood and scaler) the (N,)
chain from eps to the likelihood sum runs in K4 once per sample
(ops/fused_elbo.py); otherwise it runs as tensor ops with eps from one K3
launch. The MLP runs once per step either way. Laue sums the likelihood
through its convolved form, once per sample, and never takes K4
(_fused_eligible). Parameters are a nested dict of tensors in the JAX
package's layout (utils/params.py converts between the two).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device, same_device
from ...ops.distributions import Normal
from ...ops.fused_elbo import fused_likelihood_sum, prng_normal
from ...ops.plan_gather import plan_gather
from ..base import Inputs
from ..likelihoods import mono
from ..scaling.image import HybridImageScaler
from ..scaling.nn import MLPScaler


@dataclass(frozen=True, eq=False)
class VariationalMergingModel:
    posterior: Any
    prior: Any
    likelihood: Any
    scaler: Any
    mc_samples: int = 1
    kl_weight: Optional[float] = None
    # run the likelihood chain through K4 when the configuration allows
    # (a fused-supported likelihood and an MLP or hybrid scaler)
    fused_kernel: bool = False
    # the Rao-Blackwellized KL of --analytic-kl (Wilson priors)
    analytic_kl: bool = False

    def __post_init__(self):
        if self.mc_samples < 1:
            raise ValueError(f"mc_samples must be >= 1, got {self.mc_samples}")

    @property
    def metric_names(self) -> Tuple[str, ...]:
        extra = ()
        if hasattr(self.prior, "r_init"):
            extra = tuple(f"rDW_{i}"
                          for i in range(self.prior.r_init.shape[0]))
        return ("loss", "NLL", "F KLDiv") + extra

    def _built_prior(self, params: dict):
        """The prior of this step: priors with trainable parameters
        (double-Wilson r) are built from params["prior"]."""
        if hasattr(self.prior, "build"):
            return self.prior.build(params.get("prior", {}))
        return self.prior

    def _fused_likelihood_kind(self) -> Optional[Tuple[str, float]]:
        """(kind, dof) of K4's pointwise chain, or None when the likelihood
        has none (variational.py:109-124)."""
        lik = self.likelihood
        if isinstance(lik, mono.NormalLikelihood):
            return ("normal", 0.0)
        if isinstance(lik, mono.LaplaceLikelihood):
            return ("laplace", 0.0)
        if isinstance(lik, mono.StudentTEv11Likelihood):
            return ("studentt_ev11", float(lik.dof))
        if isinstance(lik, mono.StudentTLikelihood):
            return ("studentt", float(lik.dof))
        if isinstance(lik, mono.NormalEv11Likelihood):
            return ("normal_ev11", 0.0)
        return None

    @staticmethod
    def _fused_ev11_scalars(kind: str, lik_params: dict):
        """The Ev11 scalars after softplus for K4 (their gradients flow
        back through this softplus), or None for the plain kinds."""
        if not kind.endswith("_ev11"):
            return None
        return mono.ev11_scalars(lik_params)

    def _fused_eligible(self, inputs: Inputs) -> bool:
        return (self.fused_kernel
                and not inputs.is_laue
                and inputs.plans is not None
                and self._fused_likelihood_kind() is not None
                and isinstance(self.scaler, (MLPScaler, HybridImageScaler)))

    def elbo(self, params: dict, inputs: Inputs,
             generator: Optional[torch.Generator] = None, seed: int = 0,
             u_f: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None, shard=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Negative ELBO (the loss) and its metrics, an S-sample MC estimate.

        The reflection samples come from the posterior's standard noise
        u_f, (S, n_refl) uniforms for the truncated normal and (3, S,
        n_refl) normals for RiceWoolfson (drawn from `generator` when not
        given); the scale noise eps (S, N)
        (when not given) from Philox with key `seed`, sample s at indices
        [s N, (s + 1) N). At S = 1 u_f and eps may leave out the sample axis. A
        fused-eligible model runs _elbo_fused, the same estimate through
        K4 (variational.py:179-234).

        `shard` (parallel/shard.Shard), when given, places these rows at
        [row_offset, row_offset + N) of n_total and scores only the samples
        in its range (the Monte Carlo axis): row i of sample s draws Philox
        index s n_total + row_offset + i, the unsharded run's, and u_f
        stays the whole (S, n_refl). Each rank's loss is then its
        likelihood term, and rank 0's also the KL (the counterparts of
        elbo_sharded and elbo_mc_sharded, :303-568, whose psum becomes the
        Trainer's all_reduce of the gradients); metrics["ll"] is the rank's
        likelihood sum, whose total over the ranks gives the metrics
        (sharded_metrics). eps, when given, is the shard's own (S_r, N)."""
        if self._fused_eligible(inputs):
            return self._elbo_fused(params, inputs, generator, seed, u_f, eps,
                                    shard)
        q, z_f, eps = self._samples(params, inputs, generator, u_f, eps,
                                    shard)
        scale_dist = self.scaler.apply(params["scaler"], inputs)
        if not isinstance(scale_dist, Normal):
            raise TypeError("the mono chain expects a Normal scale "
                            f"distribution, got {type(scale_dist).__name__}")
        samples, row0, n_all = self._placement(inputs, shard)
        if eps is None:
            eps = self._scale_noise(seed, samples, row0, inputs.n_obs, n_all,
                                    inputs.device)
        likelihood = self.likelihood.build(params.get("likelihood", {}),
                                           inputs)
        ll_total = 0.0
        for j, s in enumerate(samples):
            z_scale = scale_dist.loc + scale_dist.scale * eps[j]
            z_obs = plan_gather(z_f[s], inputs.refl_id, inputs.plans.refl)
            ll_total = ll_total + self._masked_ll_sum(
                likelihood, z_scale * torch.square(z_obs))
        return self._loss(q, z_f, ll_total, n_all, self._built_prior(params),
                          shard)

    def _placement(self, inputs: Inputs, shard) -> Tuple[range, int, int]:
        """(the samples this call scores, its first row's index in the
        whole, the whole's rows)."""
        if shard is None:
            return range(self.mc_samples), 0, inputs.n_obs
        lo, hi = shard.samples or (0, self.mc_samples)
        return range(lo, hi), shard.row_offset, shard.n_total

    @staticmethod
    def _scale_noise(seed: int, samples: range, row0: int, n: int,
                     n_all: int, device) -> torch.Tensor:
        """(len(samples), n) Philox normals, sample s row i at index
        s n_all + row0 + i: one K3 launch when the rows are the whole,
        else one a sample."""
        if n == n_all:
            return prng_normal(len(samples) * n, seed, samples.start * n,
                               device).view(len(samples), n)
        return torch.stack([prng_normal(n, seed, s * n_all + row0, device)
                            for s in samples])

    @staticmethod
    def _masked_ll_sum(likelihood, ipred: torch.Tensor) -> torch.Tensor:
        """The log-likelihood summed over rows for one sample's (N,)
        prediction; the convolved (Laue) likelihoods have their own
        run-aligned form (models/likelihoods/laue.py masked_ll_sum). The
        port has no shard-padding mask, so every row counts."""
        if hasattr(likelihood, "masked_ll_sum"):
            return likelihood.masked_ll_sum(ipred)
        return torch.sum(likelihood.log_prob(ipred))

    def _elbo_fused(self, params: dict, inputs: Inputs,
                    generator: Optional[torch.Generator] = None,
                    seed: int = 0, u_f: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None, shard=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """elbo with the (N,) chain from eps to the likelihood sum in K4,
        once per sample; the MLP runs once (variational.py:236-300)."""
        q, z_f, eps = self._samples(params, inputs, generator, u_f, eps,
                                    shard)
        plans = inputs.plans
        samples, row0, n_all = self._placement(inputs, shard)
        if isinstance(self.scaler, HybridImageScaler):
            mlp_dist = self.scaler.mlp.apply(params["scaler"]["mlp"], inputs)
            image_scales = self.scaler.image.scales(params["scaler"]["image"])
            image_id = inputs.image_id
        else:
            mlp_dist = self.scaler.apply(params["scaler"], inputs)
            image_scales = torch.ones(1, device=inputs.device)
            image_id = torch.zeros_like(inputs.refl_id)
        image_plan = plans.image if image_scales.shape[0] > 1 else None
        kind, dof = self._fused_likelihood_kind()
        ev11 = self._fused_ev11_scalars(kind, params.get("likelihood", {}))
        ll_total = 0.0
        for j, s in enumerate(samples):
            ll_total = ll_total + fused_likelihood_sum(
                mlp_dist.loc, mlp_dist.scale, image_scales, z_f[s],
                inputs.refl_id, image_id, inputs.intensities,
                inputs.uncertainties, seed=seed, offset=s * n_all + row0,
                noise=None if eps is None else eps[j],
                refl_plan=plans.refl, image_plan=image_plan, kind=kind,
                dof=dof, ev11=ev11)
        return self._loss(q, z_f, ll_total, n_all, self._built_prior(params),
                          shard)

    def _samples(self, params, inputs, generator, u_f, eps, shard=None):
        """(q, z_f (S, n_refl), eps as (S_r, N) or None: S_r the samples
        this call scores). The posterior distribution owns the draw: u_f
        is its noise for the S samples, drawn by its draw_noise when not
        given."""
        if inputs.plans is None:
            raise ValueError("the ELBO needs gather plans (Inputs.with_plans)")
        S = self.mc_samples
        q = self.posterior.distribution(params["posterior"])
        shape = (S,) + tuple(q.loc.shape)
        if u_f is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the noise u_f")
            u_f = q.draw_noise(generator, shape, q.loc.device)
        z_f = q.sample_from_noise(u_f.reshape(q.noise_shape(shape)))
        if eps is not None:
            eps = eps.reshape(len(self._placement(inputs, shard)[0]),
                              inputs.n_obs)
        return q, z_f, eps

    def _loss(self, q, z_f, ll_total, n_obs, prior, shard=None):
        """(loss, metrics) from the likelihood summed over samples and
        observations (variational.py:220-234). z_f is (S, n_refl), or
        (S, K, n_refl) for K independent merges (parallel/xval.py), whose
        ll_total and n_obs are then (K,) and whose metrics are (K,). With a
        shard, ll_total is this rank's part and n_obs the whole's rows; the
        KL enters the loss on the rank that carries it alone."""
        S = z_f.shape[0]
        kl_sum, kl_mean = self._kl_terms(q, prior, z_f)
        nll, kl = self._nll(ll_total, S, n_obs), (
            kl_sum if self.kl_weight is None else kl_mean)
        loss = (nll if shard is not None and not shard.carries_kl
                else self._total(nll, kl))
        metrics = {"loss": loss, "NLL": nll, "F KLDiv": kl}
        if hasattr(prior, "metrics"):
            metrics.update(prior.metrics())
        if shard is not None:
            metrics["ll"] = ll_total
        return loss, metrics

    def _nll(self, ll_total, S, n_obs):
        if self.kl_weight is None:
            return -ll_total / S
        return -ll_total / (S * n_obs)

    def _total(self, nll, kl):
        return nll + kl if self.kl_weight is None else nll + self.kl_weight * kl

    def sharded_metrics(self, metrics: dict, ll_total: torch.Tensor,
                        n_obs: int) -> Dict[str, torch.Tensor]:
        """A rank's elbo metrics with the NLL and loss of the whole: from
        ll_total, the ranks' likelihood sums added up, and the whole's
        n_obs rows (the KL and the prior's metrics are every rank's
        own and equal). At one rank, the unsharded elbo's metrics bit for
        bit."""
        nll = self._nll(ll_total, self.mc_samples, n_obs)
        out = {k: v for k, v in metrics.items() if k != "ll"}
        out.update(loss=self._total(nll, metrics["F KLDiv"]), NLL=nll)
        return out

    def _kl_terms(self, q, prior, z_f) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum over reflections of the per-reflection KL estimate, mean
        over all its entries) (variational.py:570-585): the MC estimate
        log q(z_F) - log p(z_F) averaged over the samples, or with
        analytic_kl and a prior that has expected_log_prob,
        -H(q) - E_q[log p]. Reduced over the sample and reflection axes
        only, so that K merges stacked between them keep their own."""
        if (self.analytic_kl and hasattr(prior, "expected_log_prob")
                and hasattr(q, "entropy")):
            kl_term = -q.entropy() - prior.expected_log_prob(q, z_f)
            dims, n_mc = (-1,), 1
        else:
            kl_term = q.log_prob(z_f) - prior.log_prob(z_f)
            dims, n_mc = (0, -1), kl_term.shape[0]
        if kl_term.dim() == len(dims):
            return torch.sum(kl_term) / n_mc, torch.mean(kl_term)
        return (torch.sum(kl_term, dim=dims) / n_mc,
                torch.mean(kl_term, dim=dims))

    # ---------------------------------------------------- posterior outputs
    def predict_ipred(self, params: dict, inputs: Inputs,
                      generator: torch.Generator, seed: int = 0
                      ) -> torch.Tensor:
        """(S, N) samples of Ipred (variational.py:587-599): reflection
        samples from `generator`, scale noise from Philox with key `seed`,
        as the ELBO draws them."""
        with torch.no_grad():
            _, z_f, _ = self._samples(params, inputs, generator, None, None)
            S, n = z_f.shape[0], inputs.n_obs
            scale_dist = self.scaler.apply(params["scaler"], inputs)
            eps = prng_normal(S * n, seed, 0, inputs.device).view(S, n)
            z_obs = torch.stack([plan_gather(z_f[s], inputs.refl_id,
                                             inputs.plans.refl)
                                 for s in range(S)])
            return (scale_dist.loc + scale_dist.scale * eps) \
                * torch.square(z_obs)

    def _convolve(self, inputs: Inputs):
        """The Laue harmonic convolution of the likelihood, or None."""
        if not inputs.is_laue:
            return None
        return getattr(self.likelihood.build({}, inputs), "convolve", None)

    def scale_mean_stddev(self, params: dict, inputs: Inputs):
        """Moments of the scale posterior; Laue: convolved over harmonics
        (variational.py:602-613)."""
        with torch.no_grad():
            dist = self.scaler.apply(params["scaler"], inputs)
            mean, stddev = dist.mean(), dist.stddev()
            conv = self._convolve(inputs)
            if conv is not None:
                mean = conv(mean)
                stddev = torch.sqrt(conv(torch.square(stddev)))
            return mean, stddev

    def prediction_mean_stddev(self, params: dict, inputs: Inputs):
        """<I> and std(I) under the model (variational.py:615-630):
        <I> = <Sigma><F^2>; var(I) = <F^4><Sigma^2> - <I>^2."""
        with torch.no_grad():
            q = self.posterior.distribution(params["posterior"])
            scale_dist = self.scaler.apply(params["scaler"], inputs)
            rid = inputs.refl_id.long()
            f2 = torch.square(q.mean()) + torch.square(q.stddev())
            iexp = scale_dist.mean() * f2[rid]
            s2 = torch.square(scale_dist.mean()) \
                + torch.square(scale_dist.stddev())
            ivar = q.moment_4()[rid] * s2 - torch.square(iexp)
            conv = self._convolve(inputs)
            if conv is not None:
                iexp, ivar = conv(iexp), conv(ivar)
            return iexp, torch.sqrt(ivar)


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
    cross to the host once per chunk. The leaves of the `freeze` subtrees
    take no gradient: autograd runs no backward into them (no K1-bwd for a
    frozen scaler) and Adam steps them with zeros, which leaves them as
    they are (variational.py:707-709)."""

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
                        frozen: List[bool], batched: bool = False
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(updated grads, global norm): freeze, norm, zero non-finite,
        clipnorm per leaf, clipvalue, global clipnorm. With `batched` every
        grad has a leading axis of K independent merges (parallel/xval.py)
        and each merge is treated on its own: K norms, K clips."""
        flat, sizes = self.flat_grads(grads, frozen, batched)
        return self.transform_flat(flat, sizes, grads, batched)

    @staticmethod
    def flat_grads(grads: List[torch.Tensor], frozen: List[bool],
                   batched: bool = False) -> Tuple[torch.Tensor, List[int]]:
        """(the gradients end to end, zeros for the frozen leaves; each
        leaf's length): the buffer transform_flat works on, and the one a
        sharded step sums over the ranks."""
        k = grads[0].shape[0] if batched else None

        def rows(t):
            return t.reshape(k, -1) if batched else t.reshape(-1)
        sizes = [rows(g).shape[-1] for g in grads]
        return torch.cat([rows(torch.zeros_like(g)) if f else rows(g)
                          for g, f in zip(grads, frozen)], dim=-1), sizes

    def transform_flat(self, flat: torch.Tensor, sizes: List[int],
                       grads: List[torch.Tensor], batched: bool = False
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """transform_grads after flat_grads: the norm, the non-finite
        zeroing and the clips on the flat buffer, split back into the
        shapes of `grads`."""
        k = grads[0].shape[0] if batched else None

        def total(t):
            return (torch.sum(t, dim=-1, keepdim=True) if batched
                    else torch.sum(t))
        grad_norm = torch.sqrt(total(flat * flat))
        flat = torch.where(torch.isfinite(flat), flat, torch.zeros_like(flat))
        if self.clipnorm is not None:
            parts = []
            for g in flat.split(sizes, dim=-1):
                norm = torch.sqrt(total(g * g))
                parts.append(g * torch.clamp(
                    self.clipnorm / (norm + 1e-20), max=1.0))
            flat = torch.cat(parts, dim=-1)
        if self.clipvalue is not None:
            flat = torch.clamp(flat, -self.clipvalue, self.clipvalue)
        if self.global_clipnorm is not None:
            g_norm = torch.sqrt(total(flat * flat))
            flat = torch.where(g_norm < self.global_clipnorm, flat,
                               flat / g_norm * self.global_clipnorm)
        return ([g.reshape_as(ref) for g, ref in
                 zip(flat.split(sizes, dim=-1), grads)],
                grad_norm.reshape(k) if batched else grad_norm)

    @staticmethod
    def gradients(loss: torch.Tensor, leaves: List[torch.Tensor],
                  frozen: List[bool]) -> List[torch.Tensor]:
        """d loss / d leaf for the leaves not frozen, asked of autograd for
        those alone; zeros for the frozen ones and for leaves the loss does
        not reach."""
        live = [t for t, f in zip(leaves, frozen) if not f]
        got = iter(torch.autograd.grad(loss, live, allow_unused=True)
                   if live else ())
        out = []
        for t, f in zip(leaves, frozen):
            g = None if f else next(got)
            out.append(torch.zeros_like(t) if g is None else g)
        return out

    def train(self, params: dict, generator: torch.Generator,
              inputs: Inputs, steps: int, chunk_size: int = 100,
              device: DeviceLike = None,
              validation_data: Optional[Inputs] = None,
              validation_frequency: int = 10,
              checkpoint_path: Optional[str] = None,
              checkpoint_frequency: int = 0,
              resume_from: Optional[str] = None,
              shard=None
              ) -> Tuple[dict, Dict[str, list]]:
        """Run `steps` full-batch steps on `device` (None: the card);
        returns (params, history).

        shard (parallel/shard.Shard): `inputs` are this rank's rows, or
        all rows with the rank's samples, of a merge that every rank of
        the process group trains at once (step_gradients); every
        rank returns the same params and history, and rank 0 alone writes
        the checkpoints, which every rank resumes from. At one rank the
        run is the unsharded run bit for bit.

        `generator` (on the inputs' device) draws the reflection samples and
        one 32-bit base key; the scale noise of step i uses the Philox key
        (base, i), so distinct steps draw from disjoint streams. The
        caller's params are not modified.

        validation_data (planned Inputs of held-out rows): NLL_val is scored
        before each chunk of validation_frequency steps and repeated over
        its steps, scaled by the ratio of training to held-out rows
        (careless_tpu variational.py:804-819). Its draws leave `generator`
        untouched: with key = base | ((2**30 + done) << 32), the scale
        noise comes from that Philox key and the uniforms from a generator
        seeded with mix64(key) (torch's CPU generator reads only a seed's
        low 32 bits, which the mix makes depend on done as well); steps
        never reach 2**30, so the keys are not the steps' own.

        checkpoint_path / checkpoint_frequency: write a checkpoint
        (utils/checkpoint.py) at the end of a chunk once `frequency` steps
        have passed since the last and at the end, never for a run stopped
        by a non-finite gradient. resume_from: continue from such a file
        (the params, Adam state, step, history and, where the port wrote
        it, the generator and base key), so that a run resumed from its own
        checkpoint repeats the uninterrupted run bit for bit. The history
        is aligned to this run's metrics and start step as the JAX package
        aligns it (:791-802)."""
        from ...utils.checkpoint import (RngState, adam_prefix, load_state,
                                         save_state)
        dev = resolve_device(device)
        if not (same_device(inputs.device, dev)
                and same_device(generator.device, dev)):
            raise ValueError(f"inputs ({inputs.device}) and generator "
                             f"({generator.device}) must be on {dev}")
        if validation_data is not None and not same_device(
                validation_data.device, dev):
            raise ValueError(f"validation_data ({validation_data.device}) "
                             f"must be on {dev}")
        if validation_data is not None and validation_frequency < 1:
            raise ValueError("validation_frequency must be at least 1, got "
                             f"{validation_frequency}")
        params = map_params(
            lambda t: t.detach().to(dev).clone().requires_grad_(True), params)
        named = flatten_params(params)
        leaves = [t for _, t in named]
        frozen = [path.split("/")[0] in self.freeze for path, _ in named]
        for leaf, f in zip(leaves, frozen):
            leaf.requires_grad_(not f)
        opt = self.optimizer(leaves)
        opt_prefix = adam_prefix(self.clipnorm, self.clipvalue,
                                 self.global_clipnorm)
        start_step, resumed, rng = 0, None, None
        if resume_from is not None:
            start_step, resumed, rng = load_state(resume_from, params, opt,
                                                  opt_prefix)
        if rng is not None:
            if rng.device_type != generator.device.type:
                raise ValueError(
                    f"checkpoint {resume_from} holds a {rng.device_type} "
                    f"generator's state; this run's generator is on "
                    f"{generator.device.type}")
            generator.set_state(rng.generator)
            base = rng.base
        else:
            base = int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                                     device=generator.device).item())

        metric_keys = self.metric_keys
        history: Dict[str, list] = {k: [] for k in metric_keys}
        n_train = inputs.n_obs if shard is None else shard.n_total
        if validation_data is not None:
            history["NLL_val"] = []
            chunk_size = validation_frequency
            val_scale = n_train / validation_data.n_obs
        if resumed is not None:
            for k in history:
                v = list(resumed.get(k, ()))[:start_step]
                history[k] = v + [float("nan")] * (start_step - len(v))
        done = last_ckpt = start_step
        while done < steps:
            n = min(chunk_size, steps - done)
            if validation_data is not None:
                v = self.validation_nll(params, validation_data, base, done)
                history["NLL_val"].extend([val_scale * v] * n)
            rows = []
            for i in range(done, done + n):
                grads, grad_norm, metrics = self.step_gradients(
                    params, leaves, frozen, inputs, generator,
                    base | (i << 32), shard)
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
                break   # the last healthy checkpoint stays the resume point
            if (checkpoint_path and checkpoint_frequency > 0
                    and (done - last_ckpt >= checkpoint_frequency
                         or done >= steps)):
                if shard is None or shard.rank == 0:
                    save_state(checkpoint_path, params, opt, opt_prefix,
                               done, history,
                               RngState(generator.get_state(),
                                        generator.device.type, base))
                last_ckpt = done
        return map_params(lambda t: t.detach(), params), history

    def step_gradients(self, params: dict, leaves: List[torch.Tensor],
                       frozen: List[bool], inputs: Inputs,
                       generator: torch.Generator, seed: int, shard=None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor, dict]:
        """One step's (gradients after transform_grads, the global
        gradient norm, metrics) at `params` (whose flattened leaves are
        `leaves`), the noise from `generator` and the Philox key `seed`.
        With a shard, the rank differentiates its own loss (its likelihood
        term, and on rank 0 the KL) and one all_reduce (SUM) over the
        ranks adds the flat gradients and the likelihood sums of every
        rank; the norm, the zeroing and the clips then run on the same
        values on every rank."""
        loss, metrics = self.model.elbo(params, inputs, generator, seed=seed,
                                        shard=shard)
        grads = self.gradients(loss, leaves, frozen)
        flat, sizes = self.flat_grads(grads, frozen)
        if shard is not None:
            from ...parallel.distributed import all_reduce_sum
            buf = all_reduce_sum(torch.cat(
                [flat, metrics["ll"].detach().reshape(1)]))
            flat = buf[:-1]
            metrics = self.model.sharded_metrics(metrics, buf[-1],
                                                 shard.n_total)
        grads, grad_norm = self.transform_flat(flat, sizes, grads)
        return grads, grad_norm, metrics

    def validation_nll(self, params: dict, inputs: Inputs, base: int,
                       done: int) -> float:
        """The model's NLL on held-out rows before step `done`, drawn from
        the keys of Trainer.train's docstring."""
        key = base | ((2 ** 30 + done) << 32)
        gen = torch.Generator(device=inputs.device)
        gen.manual_seed(mix64(key))
        with torch.no_grad():
            _, metrics = self.model.elbo(params, inputs, gen, seed=key)
        return float(metrics["NLL"])


def mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers in which every
    bit of x reaches every bit of the result."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)
