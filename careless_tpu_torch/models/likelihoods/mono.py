"""Likelihoods for monochromatic data.

Counterpart of careless_tpu/models/likelihoods/mono.py:27-111: Normal,
Laplace (scale sig / sqrt 2) and StudentT(dof) on the observed intensities,
and the Ev11 (SCALA/Aimless error model) variants, whose trainable Sdfac,
Sdadd and SdB pass through softplus and widen sigma to
Sdfac sqrt(sig^2 + SdB softplus(I) + Sdadd softplus(I)^2). Each likelihood
is a static dataclass; the Ev11 parameters are 0-d tensors in
params["likelihood"]. NeuralNormalLikelihood (:114-147, not wired to the
CLI) widens sigma by an MLP of (I, sigma) whose weights are
params["likelihood"]["layers"] and ["out"].
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...ops.distributions import Laplace, Normal, StudentT, softplus
from ...ops.fused_mlp import leaky_relu
from ..base import Inputs

SOFTPLUS_INV_1 = float(np.log(np.expm1(1.0)))  # softplus(x) = 1


@dataclass(frozen=True)
class NormalLikelihood:
    def init(self, device=None) -> dict:
        return {}

    def build(self, params: dict, inputs: Inputs) -> Normal:
        return Normal(inputs.intensities, inputs.uncertainties)


@dataclass(frozen=True)
class LaplaceLikelihood:
    def init(self, device=None) -> dict:
        return {}

    def build(self, params: dict, inputs: Inputs) -> Laplace:
        return Laplace(inputs.intensities,
                       inputs.uncertainties / math.sqrt(2.0))


@dataclass(frozen=True)
class StudentTLikelihood:
    dof: float

    def init(self, device=None) -> dict:
        return {}

    def build(self, params: dict, inputs: Inputs) -> StudentT:
        return StudentT(self.dof, inputs.intensities, inputs.uncertainties)


class _Ev11Dist:
    """Distribution-like object whose scale depends on the prediction."""

    def __init__(self, loc, scale, sdfac, sdadd, sdb,
                 dof: Optional[float] = None):
        self.loc, self.scale = loc, scale
        self.sdfac, self.sdadd, self.sdb = sdfac, sdadd, sdb
        self.dof = dof

    def corrected_sigiobs(self, ipred):
        ip = softplus(ipred)
        return self.sdfac * torch.sqrt(
            torch.square(self.scale) + self.sdb * ip
            + self.sdadd * torch.square(ip))

    def log_prob(self, ipred):
        scale = self.corrected_sigiobs(ipred)
        if self.dof is None:
            return Normal(self.loc, scale).log_prob(ipred)
        return StudentT(self.dof, self.loc, scale).log_prob(ipred)

    def mean(self):
        return self.loc

    def stddev(self):
        return self.scale


def ev11_scalars(params: dict):
    """(sdfac, sdadd, sdb) after softplus, from params["likelihood"]."""
    return (softplus(params["sdfac_raw"]), softplus(params["sdadd_raw"]),
            softplus(params["sdb_raw"]))


@dataclass(frozen=True)
class NormalEv11Likelihood:
    def init(self, device=None) -> dict:
        return {k: torch.tensor(SOFTPLUS_INV_1, dtype=torch.float32,
                                device=device)
                for k in ("sdfac_raw", "sdadd_raw", "sdb_raw")}

    def build(self, params: dict, inputs: Inputs) -> _Ev11Dist:
        return _Ev11Dist(inputs.intensities, inputs.uncertainties,
                         *ev11_scalars(params))


@dataclass(frozen=True)
class StudentTEv11Likelihood:
    dof: float

    def init(self, device=None) -> dict:
        return NormalEv11Likelihood().init(device)

    def build(self, params: dict, inputs: Inputs) -> _Ev11Dist:
        return _Ev11Dist(inputs.intensities, inputs.uncertainties,
                         *ev11_scalars(params), dof=self.dof)


@dataclass(frozen=True)
class NeuralNormalLikelihood:
    """Normal(I, sigpred) with sigpred = sigma delta / mean(delta), delta
    = softplus of an MLP of (I, sigma): mlp_layers leaky-ReLU layers of
    mlp_width, then one output (mono.py:114-147). Its products are plain
    torch.matmul: the JAX package computes them with jnp.dot, outside any
    Pallas kernel, and this likelihood has no fused kind."""

    mlp_layers: int
    mlp_width: int
    leakiness: float = 0.3   # keras LeakyReLU's default alpha

    def init(self, device=None,
             generator: Optional[torch.Generator] = None) -> dict:
        """{"layers": [{w (d, width), b (width,)}, ...], "out": {w (d, 1),
        b (1,)}}: identity weights (np.eye) without a generator; with one,
        each layer's w standard normals / sqrt(d) drawn from it. The
        output layer is the identity's first column either way."""
        layers, d = [], 2
        for _ in range(self.mlp_layers):
            if generator is None:
                w = torch.as_tensor(np.eye(d, self.mlp_width,
                                           dtype=np.float32), device=device)
            else:
                w = torch.randn((d, self.mlp_width), generator=generator,
                                device=device, dtype=torch.float32) \
                    / float(np.sqrt(d))
            layers.append({"w": w, "b": torch.zeros(
                self.mlp_width, dtype=torch.float32, device=device)})
            d = self.mlp_width
        out = {"w": torch.as_tensor(np.eye(d, 1, dtype=np.float32),
                                    device=device),
               "b": torch.zeros(1, dtype=torch.float32, device=device)}
        return {"layers": layers, "out": out}

    def build(self, params: dict, inputs: Inputs) -> Normal:
        x = torch.stack([inputs.intensities, inputs.uncertainties], dim=-1)
        for layer in params["layers"]:
            x = leaky_relu(torch.matmul(x, layer["w"]) + layer["b"],
                           self.leakiness)
        delta = softplus(torch.matmul(x, params["out"]["w"])
                         + params["out"]["b"])[..., 0]
        sigpred = inputs.uncertainties * delta / torch.mean(delta)
        return Normal(inputs.intensities, sigpred)
