"""DataManager: from formatted inputs and the parsed flags to a model.

Counterpart of careless_tpu/io/manager.py:42-203: table sizes, the Wilson
prior, and build_model (TruncatedNormal surrogate initialised from the
prior's moments with centric low = 0 and acentric low = 1e-32; the Normal,
StudentT, Normal-Ev11 or StudentT-Ev11 likelihood of
--studentt-likelihood-dof and --refine-uncertainties, convolved over
harmonic groups for Laue inputs;
an MLP with the exp or softplus bijector and the --mlp-dtype of its
products, alone, under per-image scales (HybridImageScaler) or followed by
--image-layers per-image banks (NeuralImageScaler);
--mc-samples and the --fused-kernel auto/on/off policy). Options outside
the ported slice raise NotImplementedError naming the flag. Output writing
(get_results, get_predictions) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.base import Inputs
from ..models.likelihoods import laue, mono
from ..models.merging.surrogate import TruncatedNormalPosterior
from ..models.merging.variational import Trainer, VariationalMergingModel
from ..models.priors.wilson import WilsonPrior
from ..models.scaling.image import (HybridImageScaler, ImageScaler,
                                    NeuralImageScaler)
from ..models.scaling.nn import MLPScaler

# (flag, attribute, value that selects the unported option)
_UNPORTED = (
    ("--double-wilson-parents", "parents", lambda v: v is not None),
    ("--analytic-kl", "analytic_kl", bool),
)


class DataManager:
    """asu_collection exposes per-reflection `centric`, `multiplicity` and
    `dHKL` arrays; parser is the CLI namespace (careless_tpu/args)."""

    def __init__(self, inputs: Inputs, asu_collection, parser=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.inputs = inputs.to(self.device)
        self.asu_collection = asu_collection
        self.parser = parser

    @property
    def n_refl(self) -> int:
        """Global posterior-table size (= ASU-collection length)."""
        return len(np.asarray(self.asu_collection.centric))

    @property
    def n_images(self) -> int:
        """Global image-table size: plans for any subset must use it."""
        return int(self.inputs.image_id.max()) + 1

    @property
    def mlp_width(self) -> int:
        width = getattr(self.parser, "mlp_width", None)
        return int(width) if width is not None \
            else int(self.inputs.metadata.shape[-1])

    @staticmethod
    def wilson_sigma(b: float, dHKL: np.ndarray) -> np.ndarray:
        return np.exp(-0.25 * b / (dHKL * dHKL))

    def get_wilson_sigma(self, b: Optional[float] = None):
        if b is None:
            return 1.0
        return self.wilson_sigma(b, np.asarray(self.asu_collection.dHKL))

    def get_wilson_prior(self, b: Optional[float] = None, k: float = 1.0
                         ) -> WilsonPrior:
        sigma = self.get_wilson_sigma(b) * k
        dev = self.device
        return WilsonPrior(
            torch.as_tensor(np.asarray(self.asu_collection.centric, bool),
                            device=dev),
            torch.as_tensor(np.asarray(self.asu_collection.multiplicity,
                                       np.float32), device=dev),
            float(sigma) if np.isscalar(sigma) else torch.as_tensor(
                np.asarray(sigma, np.float32), device=dev))

    def build_model(self, parser=None
                    ) -> Tuple[VariationalMergingModel, dict, Trainer]:
        """(model, initial params, trainer) from the parsed flags, on this
        manager's device."""
        parser = parser or self.parser
        if parser is None:
            raise ValueError("No parser supplied, but self.parser is unset")
        for flag, attr, selects in _UNPORTED:
            if selects(getattr(parser, attr, None)):
                raise NotImplementedError(f"{flag} is not ported yet")
        dev = self.device

        prior = self.get_wilson_prior(parser.wilson_prior_b)
        loc = prior.mean().cpu().numpy()
        scale = (prior.stddev().cpu().numpy()
                 * parser.structure_factor_init_scale)
        low = (1e-32 * ~np.asarray(self.asu_collection.centric, bool)
               ).astype(np.float32)
        posterior = TruncatedNormalPosterior(
            low=torch.as_tensor(low, device=dev), high=1e10,
            scale_shift=parser.epsilon)

        width = self.mlp_width
        bijector = parser.scale_bijector.lower()
        if bijector == "softplus":
            istd = float(np.std(self.inputs.intensities.cpu().numpy()))
        elif bijector == "exp":
            istd = None
        else:
            raise ValueError(
                f"Unsupported scale bijector type, {parser.scale_bijector}")
        mlp = MLPScaler(parser.mlp_layers, width, epsilon=parser.epsilon,
                        scale_bijector=bijector, scale_multiplier=istd,
                        mlp_dtype=getattr(parser, "mlp_dtype", None)
                        or "float32")
        if (getattr(parser, "image_layers", None) or 0) > 0:
            scaler = NeuralImageScaler(parser.image_layers, self.n_images,
                                       mlp)
        elif parser.use_image_scales:
            scaler = HybridImageScaler(mlp, ImageScaler(self.n_images))
        else:
            scaler = mlp

        lik = laue if self.inputs.is_laue else mono
        dof = getattr(parser, "studentt_likelihood_dof", None)
        if getattr(parser, "refine_uncertainties", False):
            likelihood = (lik.StudentTEv11Likelihood(dof) if dof is not None
                          else lik.NormalEv11Likelihood())
        else:
            likelihood = (lik.StudentTLikelihood(dof) if dof is not None
                          else lik.NormalLikelihood())

        # dispatch policy of careless_tpu/io/manager.py:170-175: 'auto'
        # takes K4 at mc > 1 from 500k observations; 'on'/'off' force it
        mc = getattr(parser, "mc_samples", None) or 1
        fused_flag = getattr(parser, "fused_kernel", None) or "auto"
        if fused_flag == "auto":
            fused = mc > 1 and self.inputs.n_obs >= 500_000
        else:
            fused = fused_flag == "on"

        model = VariationalMergingModel(
            posterior=posterior, prior=prior, likelihood=likelihood,
            scaler=scaler, mc_samples=mc, kl_weight=parser.kl_weight,
            fused_kernel=fused)
        params = {"posterior": posterior.init(loc, scale, dev),
                  "scaler": scaler.init(self.inputs.metadata.shape[-1], dev)}
        lik_init = likelihood.init(dev)
        if lik_init:
            params["likelihood"] = lik_init

        freeze = []
        if getattr(parser, "freeze_scales", False):
            freeze.append("scaler")
        if getattr(parser, "freeze_structure_factors", False):
            freeze.append("posterior")
        trainer = Trainer(
            model, learning_rate=parser.learning_rate, beta_1=parser.beta_1,
            beta_2=parser.beta_2, clipnorm=parser.clipnorm,
            clipvalue=parser.clipvalue,
            global_clipnorm=parser.global_clipnorm, freeze=tuple(freeze))
        return model, params, trainer
