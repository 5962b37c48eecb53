"""DataManager: from formatted inputs and the parsed flags to a model.

Counterpart of careless_tpu/io/manager.py:42-203: table sizes, the Wilson
prior, and build_model (the Wilson prior, or the double-Wilson prior of
--double-wilson-parents with its trainable r in params["prior"] under
--optimize-double-wilson-r; --analytic-kl; a TruncatedNormal surrogate
initialised from the prior's moments with centric low = 0 and acentric
low = 1e-32; the Normal,
StudentT, Normal-Ev11 or StudentT-Ev11 likelihood of
--studentt-likelihood-dof and --refine-uncertainties, convolved over
harmonic groups for Laue inputs;
an MLP with the exp or softplus bijector and the --mlp-dtype of its
products, alone, under per-image scales (HybridImageScaler) or followed by
--image-layers per-image banks (NeuralImageScaler);
--mc-samples and the --fused-kernel auto/on/off policy). The outputs
(manager.py:266-415): get_results (merged F/SigF, I from the moments,
redundancy N over every row, Laue's expanded harmonics included, the
posterior's parameters; reflections with N > 0) and get_predictions
(per-observation tables; for Laue one row per harmonic group), with
_unstack_anomalous's (+)/(-) columns in PHENIX order, as numpy DataSets
(no pandas). The splitters (manager.py:206-263: by reflection or by image,
Laue groups kept whole, renumbered and repacked) draw from numpy's
default_rng(seed), so a seed holds out the JAX package's rows. Training and the outputs run on the planned copy of the
inputs (planned_inputs: mono rows sorted by refl_id, Laue rows in the
harmonic-chain layout), whose maps put the outputs back in row and group
order. to_pickle and from_pickle (manager.py:52-60, --save-data-manager)
keep a manager in a pickle of numpy arrays and the port's host classes,
which loads where no CUDA is present; the planned copies are not kept
and are rebuilt on demand. The JAX package's pickle holds jax arrays and
careless_tpu classes, so the port does not read it.
"""
from __future__ import annotations

import io
import pickle
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.base import ROW_FIELDS, Inputs
from ..models.likelihoods import laue, mono
from ..models.merging.surrogate import TruncatedNormalPosterior
from ..models.merging.variational import Trainer, VariationalMergingModel
from ..models.priors.double_wilson import build_double_wilson_prior
from ..models.priors.wilson import WilsonPrior
from ..models.scaling.image import (HybridImageScaler, ImageScaler,
                                    NeuralImageScaler)
from ..models.scaling.nn import MLPScaler
from ..xtal import DataSet
from .asu import pack_hkl

# MTZ dtypes for output columns
_RESULT_DTYPES = {"H": "H", "K": "H", "L": "H", "F": "F", "SigF": "Q",
                  "I": "J", "SigI": "Q", "N": "R",
                  "high": "R", "loc": "R", "low": "R", "scale": "R"}
_PRED_DTYPES = {"H": "H", "K": "H", "L": "H", "asu_id": "I", "image_id": "I",
                "file_id": "I", "test": "I", "Iobs": "J", "SigIobs": "Q",
                "Ipred": "J", "SigIpred": "Q", "Scale": "J", "SigScale": "Q"}


# planned copies a DataManager keeps (planned_inputs)
_PLANS_KEPT = 2


class Planned(NamedTuple):
    """The planned copy of an Inputs and its maps back."""
    inputs: Inputs                  # reordered rows with plans
    order: torch.Tensor             # original row of each planned row
    groups: Optional[torch.Tensor]  # Laue: original group of each group


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise pickle.PicklingError(
                f"a {obj.device} tensor of shape {tuple(obj.shape)} would "
                "be pickled; DataManager keeps numpy arrays in its pickle")
        return NotImplemented


class DataManager:
    """asu_collection exposes per-reflection `centric`, `multiplicity` and
    `dHKL` arrays; parser is the CLI namespace (careless_tpu/args)."""

    def __init__(self, inputs: Inputs, asu_collection, parser=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.inputs = inputs.to(self.device)
        self.asu_collection = asu_collection
        self.parser = parser
        self.rng = np.random.default_rng(
            getattr(parser, "seed", None) if parser is not None else None)
        self._planned = []   # (inputs, Planned), most recent last

    # ------------------------------------------------------------- pickling
    def __getstate__(self) -> dict:
        """The manager with every tensor as a numpy array: Inputs' row
        fields as a dict of arrays (None where absent), the device as its
        name; the planned copies are left out (planned_inputs rebuilds
        them, to the same rows and plans)."""
        state = dict(self.__dict__)
        state["inputs"] = {f: None if getattr(self.inputs, f) is None
                           else _numpy(getattr(self.inputs, f))
                           for f in ROW_FIELDS}
        state["device"] = str(self.device)
        state["_planned"] = []
        return state

    def __setstate__(self, state: dict) -> None:
        """Back to tensors on the CPU; from_pickle moves them on."""
        state = dict(state)
        state["inputs"] = Inputs(**{
            f: None if v is None else torch.as_tensor(v)
            for f, v in state["inputs"].items()})
        state["device"] = torch.device("cpu")
        self.__dict__.update(state)

    def to_pickle(self, filename: str) -> None:
        """Write the manager (__getstate__'s numpy form). A tensor left
        anywhere in it, whose pickle would load only where its device
        exists, raises before the file is opened."""
        buf = io.BytesIO()
        _HostPickler(buf).dump(self)
        with open(filename, "wb") as f:
            f.write(buf.getvalue())

    @classmethod
    def from_pickle(cls, filename: str,
                    device: DeviceLike = None) -> "DataManager":
        """The manager to_pickle wrote, its inputs on `device` (None: the
        card)."""
        with open(filename, "rb") as f:
            dm = pickle.load(f)
        if not isinstance(dm, cls):
            raise TypeError(f"{filename} holds a {type(dm).__name__}, not "
                            f"a {cls.__name__}")
        dm.device = resolve_device(device)
        dm.inputs = dm.inputs.to(dm.device)
        return dm

    # ----------------------------------------------------------- table sizes
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
        dev = self.device

        if getattr(parser, "parents", None) is not None:
            prior = build_double_wilson_prior(self, parser)
        else:
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
            fused_kernel=fused,
            analytic_kl=bool(getattr(parser, "analytic_kl", False)))
        params = {"posterior": posterior.init(loc, scale, dev),
                  "scaler": scaler.init(self.inputs.metadata.shape[-1], dev)}
        lik_init = likelihood.init(dev)
        if lik_init:
            params["likelihood"] = lik_init
        prior_init = prior.init(dev) if hasattr(prior, "init") else {}
        if prior_init:
            params["prior"] = prior_init

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

    def planned_inputs(self, inputs: Optional[Inputs] = None) -> Planned:
        """The rows of `inputs` (default: this manager's) that training and
        the outputs run on, with the gather plans at the global table
        sizes: mono rows stably sorted by refl_id, Laue rows in the
        harmonic-chain layout (sorted_by_harmonic(n_refl), its groups
        renumbered), as careless_tpu/main.py:245-256 lays them out. Built
        once per Inputs: the last _PLANS_KEPT are kept, so that a test
        split's training, validation and two prediction passes build two
        plans."""
        inputs = self.inputs if inputs is None else inputs
        for held, planned in self._planned:
            if held is inputs:
                return planned
        rows = self.planned_rows(inputs)
        planned = rows._replace(inputs=rows.inputs.with_plans(
            self.n_refl, self.n_images))
        self._planned = (self._planned + [(inputs, planned)])[-_PLANS_KEPT:]
        return planned

    def planned_rows(self, inputs: Inputs) -> Planned:
        """planned_inputs' row layout of `inputs` and its maps, without the
        plans (the parallel crossvalidation plans the halves together)."""
        if inputs.is_laue:
            rows, order, groups = inputs.harmonic_layout(self.n_refl)
        else:
            order = torch.sort(inputs.refl_id.long(), stable=True).indices
            rows, groups = inputs.select(order), None
        return Planned(rows, order, groups)

    # ------------------------------------------------------------ splitting
    def split_mono_data_by_mask(self, test_idx: np.ndarray
                                ) -> Tuple[Inputs, Inputs]:
        """(rows where test_idx is False, rows where it is True), each in
        the original order."""
        test = torch.as_tensor(np.asarray(test_idx, bool),
                               device=self.device)
        return self.inputs.select(~test), self.inputs.select(test)

    def split_laue_data_by_mask(self, test_idx: np.ndarray
                                ) -> Tuple[Inputs, Inputs]:
        """Split Laue inputs by a row mask that cuts no harmonic group;
        each half's groups are renumbered 0.. in id order and its
        group-indexed intensities and uncertainties repacked, padded with
        1.0 to the half's rows (manager.py:210-242)."""
        test_idx = np.asarray(test_idx, bool)
        harmonic_id = _numpy(self.inputs.harmonic_id)
        isect = np.intersect1d(harmonic_id[test_idx],
                               harmonic_id[~test_idx])
        if len(isect) > 0:
            raise ValueError("test_idx splits harmonic observations with "
                             f"harmonic_id : {isect}")
        inputs = self.inputs

        def split(idx: np.ndarray) -> Inputs:
            uni, inv = np.unique(harmonic_id[idx], return_inverse=True)
            n_rows = int(idx.sum())

            def repack(v):
                v = _numpy(v)[uni]
                return np.pad(v, (0, n_rows - len(v)), constant_values=1.0)

            rows = torch.as_tensor(np.flatnonzero(idx), device=self.device)
            return inputs.select(rows).replace(
                intensities=torch.as_tensor(
                    repack(inputs.intensities), device=self.device),
                uncertainties=torch.as_tensor(
                    repack(inputs.uncertainties), device=self.device),
                harmonic_id=torch.as_tensor(inv.astype(np.int32),
                                            device=self.device))

        return split(~test_idx), split(test_idx)

    def split_data_by_refl(self, test_fraction: float = 0.5
                           ) -> Tuple[Inputs, Inputs]:
        """(train, test): each row (Laue: each harmonic group) held out with
        probability test_fraction, drawn from self.rng as the JAX package
        draws it (manager.py:244-252)."""
        if self.inputs.is_laue:
            harmonic_id = _numpy(self.inputs.harmonic_id)
            test_idx = (self.rng.random(harmonic_id.max() + 1)
                        <= test_fraction)[harmonic_id]
            return self.split_laue_data_by_mask(test_idx)
        test_idx = self.rng.random(self.inputs.n_obs) <= test_fraction
        return self.split_mono_data_by_mask(test_idx)

    def split_data_by_image(self, test_fraction: float = 0.5
                            ) -> Tuple[Inputs, Inputs]:
        """(train, test) by whole images, each half holding at least one
        image (manager.py:254-263)."""
        image_id = _numpy(self.inputs.image_id)
        test_idx = self.rng.random(image_id.max() + 1) <= test_fraction
        if not test_idx.any():
            test_idx[0] = True
        elif test_idx.all():
            test_idx[0] = False
        test_idx = test_idx[image_id]
        if self.inputs.is_laue:
            return self.split_laue_data_by_mask(test_idx)
        return self.split_mono_data_by_mask(test_idx)

    # --------------------------------------------------------------- output
    def get_results(self, posterior_dist, inputs: Optional[Inputs] = None,
                    output_parameters: bool = True,
                    max_intensity_snr: float = 1e-5) -> Tuple[DataSet, ...]:
        """Merged per-ASU outputs (manager.py:266-317)."""
        if inputs is None:
            inputs = self.inputs
        F = _numpy(posterior_dist.mean())
        SigF = _numpy(posterior_dist.stddev())
        I = SigF * SigF + F * F
        f4 = _numpy(posterior_dist.moment_4())
        ivar = np.square(I * max_intensity_snr)
        ivar = np.maximum(ivar, f4 - I * I)
        SigI = np.sqrt(ivar)

        params = None
        if output_parameters:
            d = posterior_dist
            params = {
                "high": np.broadcast_to(np.float32(_numpy(d.high)),
                                        F.shape).astype(np.float32),
                "loc": _numpy(d.loc).astype(np.float32),
                "low": np.broadcast_to(_numpy(d.low).astype(np.float32),
                                       F.shape),
                "scale": _numpy(d.scale).astype(np.float32),
            }

        asu_id, H = self.asu_collection.to_asu_id_and_miller_index(
            np.arange(len(F)))
        refl_id = _numpy(inputs.refl_id)
        N = np.bincount(refl_id, minlength=len(F)).astype(np.float32)

        results = ()
        for i, asu in enumerate(self.asu_collection):
            idx = asu_id == i
            cols = {
                "H": H[idx, 0].astype(np.int32),
                "K": H[idx, 1].astype(np.int32),
                "L": H[idx, 2].astype(np.int32),
                "F": F[idx].astype(np.float32),
                "SigF": SigF[idx].astype(np.float32),
                "I": I[idx].astype(np.float32),
                "SigI": SigI[idx].astype(np.float32),
                "N": N[idx],
            }
            if params is not None:
                for key in sorted(params):
                    cols[key] = params[key][idx]
            output = DataSet(cols, cell=asu.cell, spacegroup=asu.spacegroup,
                             mtz_dtypes=dict(_RESULT_DTYPES))
            output = output.select(output["N"] > 0)
            if asu.anomalous:
                output = _unstack_anomalous(output, asu)
            results += (output,)
        return results

    def get_predictions(self, model: VariationalMergingModel, params: dict,
                        inputs: Optional[Inputs] = None, test_value: int = 0
                        ) -> Iterator[DataSet]:
        """Prediction tables, one per ASU (manager.py:319-369): mono one
        row per observation in the order of `inputs`, Laue one row per
        harmonic group in group-id order, taken at the group's first row.
        The moments are the model's (prediction_mean_stddev and
        scale_mean_stddev; Laue's summed over each group by the
        likelihood's convolve, the run sums that training takes), computed
        on the planned copy (planned_inputs) and put back in row or group
        order."""
        if inputs is None:
            inputs = self.inputs
        refl_id = _numpy(inputs.refl_id)
        asu_id, H = self.asu_collection.to_asu_id_and_miller_index(refl_id)
        file_id = _numpy(inputs.file_id)
        image_id = _numpy(inputs.image_id)
        planned = self.planned_inputs(inputs)
        if inputs.is_laue:
            _, first_idx = np.unique(_numpy(inputs.harmonic_id),
                                     return_index=True)
        else:
            first_idx = np.arange(len(refl_id))   # every row its own

        def unplanned(t):
            if not inputs.is_laue:
                dest = planned.order
            elif planned.groups is None:
                return _numpy(t)
            else:   # group g's sum sits at its renumbered id
                dest = planned.groups
                t = t[:dest.shape[0]]
            out = torch.empty_like(t)
            out[dest] = t
            return _numpy(out)
        ipred, sigipred = map(unplanned, model.prediction_mean_stddev(
            params, planned.inputs))
        scale, sigscale = map(unplanned, model.scale_mean_stddev(
            params, planned.inputs))
        iobs = _numpy(inputs.intensities)
        sig_iobs = _numpy(inputs.uncertainties)

        num = len(first_idx)
        cols = {
            "H": H[first_idx, 0].astype(np.int32),
            "K": H[first_idx, 1].astype(np.int32),
            "L": H[first_idx, 2].astype(np.int32),
            "asu_id": asu_id[first_idx].astype(np.int32),
            "image_id": image_id[first_idx].astype(np.int32),
            "file_id": file_id[first_idx].astype(np.int32),
            "test": np.full(num, test_value, np.int32),
            "Iobs": iobs[:num].astype(np.float32),
            "SigIobs": sig_iobs[:num].astype(np.float32),
            "Ipred": ipred[:num].astype(np.float32),
            "SigIpred": sigipred[:num].astype(np.float32),
            "Scale": scale[:num].astype(np.float32),
            "SigScale": sigscale[:num].astype(np.float32),
        }
        table = DataSet(cols, mtz_dtypes=dict(_PRED_DTYPES))
        for i, rasu in enumerate(self.asu_collection):
            result = table.select(table["asu_id"] == i)
            result.cell, result.spacegroup = rasu.cell, rasu.spacegroup
            yield result


_ANOM_KEYS = ["F(+)", "SigF(+)", "F(-)", "SigF(-)",
              "I(+)", "SigI(+)", "I(-)", "SigI(-)", "N(+)", "N(-)"]


def _unstack_anomalous(ds: DataSet, asu) -> DataSet:
    """Friedel-separated table -> two-column (+/-) format with PHENIX column
    order (manager.py:372-415). Centric reflections appear only in the (+)
    columns. Rows: the union of both sides' (H, K, L), sorted
    lexicographically, as pandas' outer join sorts it; a side without a
    reflection holds NaN there."""
    hkl = ds.get_hkls()
    plus_hkl, _ = asu.spacegroup.map_to_asu(hkl, anomalous=False)
    is_minus = np.any(hkl != plus_hkl, axis=1)
    keys = pack_hkl(plus_hkl)
    union, first = np.unique(keys, return_index=True)
    cols = {"H": plus_hkl[first, 0], "K": plus_hkl[first, 1],
            "L": plus_hkl[first, 2]}
    value_cols = [c for c in ds.columns if c not in ("H", "K", "L")]
    joined = {}
    for sign, rows in (("(+)", ~is_minus), ("(-)", is_minus)):
        at = np.searchsorted(union, keys[rows])
        for c in value_cols:
            v = ds[c][rows]
            col = np.full(len(union), np.nan,
                          dtype=np.result_type(v.dtype, np.float32))
            col[at] = v
            joined[c + sign] = col
    ordered = ([k for k in _ANOM_KEYS if k in joined]
               + [k for k in joined if k not in _ANOM_KEYS])
    cols.update((k, joined[k]) for k in ordered)

    mtz_dtypes = {"H": "H", "K": "H", "L": "H"}
    for c in ordered:
        root = c.replace("(+)", "").replace("(-)", "")
        base_t = _RESULT_DTYPES.get(root, "R")
        if base_t == "F":
            base_t = "G"
        elif base_t == "J":
            base_t = "K"
        elif base_t == "Q":
            base_t = "M" if root in ("SigI",) else "L"
        mtz_dtypes[c] = base_t
    return DataSet(cols, cell=ds.cell, spacegroup=ds.spacegroup,
                   mtz_dtypes=mtz_dtypes)
