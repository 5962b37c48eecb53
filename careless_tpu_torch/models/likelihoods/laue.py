"""Convolved likelihoods for polychromatic (Laue) data.

Counterpart of careless_tpu/models/likelihoods/laue.py. Harmonics overlap
on the detector: the per-observation predictions are summed over
harmonic_id into group buckets, and the base (mono) likelihood scores the
convolved prediction against the group's packed intensity. Rows past the
group count are padding with a finite log-prob and no gradient in the
prediction.

The training path takes the run-aligned form (ops/conv_runs.py) when the
inputs carry a ConvRunPlan: no gathers, the log-prob at each group's first
row, plus the static tail of never-hit group rows; the outputs' convolve
(the prediction table's moments) takes the same run sums. Otherwise the
convolution is the planned segment sum (ops/plan_gather.plan_convolve),
whose backward is a gather by harmonic_id through K5 past the VMEM cap.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.conv_runs import conv_start_sums
from ...ops.plan_gather import plan_convolve
from ..base import Inputs
from . import mono


class ConvolvedLikelihood:
    """log_prob(v) = distribution.log_prob(convolve(v))."""

    def __init__(self, distribution, harmonic_id, plan=None, run_plan=None,
                 row_distribution=None):
        self.distribution = distribution
        self.harmonic_id = harmonic_id
        self.plan = plan
        # the run-aligned form: the base distribution built on the group
        # values broadcast to rows
        self.run_plan = run_plan
        self.row_distribution = row_distribution

    def convolve(self, value: torch.Tensor) -> torch.Tensor:
        """Sum (..., N) values over harmonic_id into same-length buckets: with
        a run plan, each run's shifted adds (training's sums) put at its
        group's bucket; else the planned segment sum."""
        rp = self.run_plan
        if rp is None:
            return plan_convolve(value, self.harmonic_id, self.plan)
        starts = rp.run_len > 0
        out = torch.zeros_like(value)
        out[..., self.harmonic_id[starts].long()] = \
            conv_start_sums(value, rp)[..., starts]
        return out

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self.distribution.log_prob(self.convolve(value))

    def masked_ll_sum(self, ipred: torch.Tensor) -> torch.Tensor:
        """Sum over group rows of log_prob(ipred), ipred (..., N); the port
        has no shard-padding mask, so every group row counts: the sum of
        masked_ll_rows."""
        return torch.sum(self.masked_ll_rows(ipred))

    def masked_ll_rows(self, ipred: torch.Tensor) -> torch.Tensor:
        """masked_ll_sum's terms, (..., N). With a run plan: each group's
        log-prob at its run-start row against row_distribution, and each
        never-hit group row's scored at 0 (careless_tpu laue.py:55-77) at
        its own row; the same value as the convolved sum by construction.
        Without one: each bucket's log-prob of the convolved prediction.
        Rows whose group ids and buckets lie among them (the halves of
        parallel/xval.py) sum to their own groups' log-likelihood. The run
        plan bakes in the intensities; a plan is dropped whenever the
        fields it was built from change (Inputs.replace)."""
        rp = self.run_plan
        if rp is None or self.row_distribution is None:
            return self.log_prob(ipred)
        conv = conv_start_sums(ipred, rp)
        tail = self.distribution.log_prob(torch.zeros_like(rp.iobs_row))
        return (self.row_distribution.log_prob(conv) * rp.start_ll_mask
                + tail * rp.tail_mask)


def _build_convolved(base, params: dict, inputs: Inputs
                     ) -> ConvolvedLikelihood:
    """Wrap a mono likelihood into the convolved form, with the run-aligned
    form when the inputs carry a ConvRunPlan."""
    plans = inputs.plans
    run = plans.harmonic_run if plans is not None else None
    row_dist = None
    if run is not None:
        row_dist = base.build(params, inputs.replace(
            intensities=run.iobs_row, uncertainties=run.sig_row))
    return ConvolvedLikelihood(
        base.build(params, inputs), inputs.harmonic_id,
        plan=plans.harmonic if plans is not None else None, run_plan=run,
        row_distribution=row_dist)


@dataclass(frozen=True)
class _Convolved:
    """A Laue likelihood: its mono base() wrapped in the convolution."""

    def base(self):
        raise NotImplementedError

    def init(self, device=None) -> dict:
        return self.base().init(device)

    def build(self, params: dict, inputs: Inputs) -> ConvolvedLikelihood:
        return _build_convolved(self.base(), params, inputs)


@dataclass(frozen=True)
class NormalLikelihood(_Convolved):
    def base(self):
        return mono.NormalLikelihood()


@dataclass(frozen=True)
class LaplaceLikelihood(_Convolved):
    def base(self):
        return mono.LaplaceLikelihood()


@dataclass(frozen=True)
class NormalEv11Likelihood(_Convolved):
    def base(self):
        return mono.NormalEv11Likelihood()


@dataclass(frozen=True)
class StudentTLikelihood(_Convolved):
    dof: float

    def base(self):
        return mono.StudentTLikelihood(self.dof)


@dataclass(frozen=True)
class StudentTEv11Likelihood(_Convolved):
    dof: float

    def base(self):
        return mono.StudentTEv11Likelihood(self.dof)
