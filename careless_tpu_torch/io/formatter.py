"""Input formatters: reflection files -> packed Inputs + ASU collection.

The port's own copy of careless_tpu/io/formatter.py on the numpy DataSet
(no pandas): its helpers, DataFormatter, MonoFormatter and LaueFormatter.
Per-file prep (resolution cutoff, systematic absences, Hobs/Kobs/Lobs
metadata, ASU mapping, MTZ-dtype-based key guessing, I/sigI cutoff; for
Laue the harmonic expansion to dmin and the wavelength band), global
concatenation with file_id/asu_id columns, the ASU collection built at the
global dmin, global image renumbering (the sorted (file_id, image_id)
pairs, numbered as pandas' groupby().ngroup() numbers them), metadata
z-scoring + positional encodings, and packing into the flat
per-observation arrays of the port's Inputs (for Laue with harmonic-group
ids and group-indexed intensities). MTZ and CrystFEL .stream files are
read; `poly` refuses .stream, as the JAX package does.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..models.base import Inputs
from ..utils.laue import expand_harmonics
from ..utils.positional_encoding import positional_encoding
from ..xtal import DataSet, SpaceGroup, concat_datasets, read_mtz
from .asu import ReciprocalASU, ReciprocalASUCollection


def check_for_key_error(key, dtype, flag, ds):
    if key is not None and key in ds:
        return
    if key is None:
        msg = (f"Unable to determine the {dtype} column key. Please use {flag} "
               f"to specify the {dtype} key name or ensure your input has a "
               f"column with the {dtype} dtype.")
    else:
        msg = (f"User supplied {dtype} column key {key}, but {key} is not "
               "available in the input data.")
    raise ValueError(msg + " Available keys are: \n" + ",".join(ds.columns))


def check_for_metadata_key_error(keys, ds):
    missing = [k for k in keys if k not in ds]
    if missing:
        msg = "".join(f'Metadata key "{k}" not found in input data. \n'
                      for k in missing)
        raise ValueError(msg + "Available keys are: \n" + ",".join(ds.columns))


def get_first_key_of_dtype(ds: DataSet, dtype: str) -> Optional[str]:
    for k in ds.columns:
        if ds.mtz_dtypes.get(k) == dtype:
            return k
    return None


def standardize_metadata(metadata: np.ndarray,
                         metadata_keys: Optional[Sequence[str]] = None
                         ) -> np.ndarray:
    """Z-score columns, skipping (and warning about) zero-variance ones."""
    std = metadata.std(0)
    zeros = std == 0.0
    for k, v in enumerate(std):
        if v == 0.0:
            name = metadata_keys[k] if metadata_keys is not None else k
            message = (f'Metadata column "{name}" with zero standard '
                       "deviation will not be standardized.")
            print(message)
            warnings.warn(message)
    metadata[:, ~zeros] = ((metadata[:, ~zeros] - metadata[:, ~zeros].mean(0))
                           / metadata[:, ~zeros].std(0))
    return metadata


def _cell_compatible_with_spacegroup(cell, sg: SpaceGroup) -> bool:
    """The cell metric must be invariant under every point-group rotation."""
    G = cell.metric_tensor()
    for rot in {op.rot for op in sg.ops}:
        R = np.array(rot, dtype=np.float64)
        if not np.allclose(R.T @ G @ R, G, rtol=1e-3, atol=1e-4 * np.abs(G).max()):
            return False
    return True


def _load(filename: str) -> DataSet:
    if filename.endswith(".mtz"):
        return read_mtz(filename)
    if filename.endswith(".stream"):
        from ..xtal.stream import read_crystfel
        return read_crystfel(filename)
    raise ValueError(f"Unsupported reflection file type: {filename}")


def _parse_spacegroups(spec: Optional[str], n_files: int
                       ) -> Optional[List[SpaceGroup]]:
    if spec is None:
        return None
    sgs = [SpaceGroup.from_name(s.strip()) for s in spec.split(",")]
    if len(sgs) == 1:
        return sgs * n_files
    if len(sgs) != n_files:
        raise ValueError(
            "Multiple values provided for --spacegroups=, but the number of "
            "provided values does not match the number of reflection files. "
            "Either provide a single spacegroup or one per reflection file "
            "as a comma-separated list.")
    return sgs


def _ngroup(*keys: np.ndarray) -> np.ndarray:
    """Group numbers of the rows' key tuples, the groups numbered in the
    sorted order of their keys (pandas' groupby(keys).ngroup()). Keys whose
    ranges fit 62 bits together are packed into one int64 in the same
    order, which np.unique sorts far faster than rows."""
    cols = [np.asarray(k, np.int64).reshape(-1) for k in keys]
    if cols and len(cols[0]):
        lows = [int(c.min()) for c in cols]
        spans = [int(c.max()) - lo + 1 for c, lo in zip(cols, lows)]
        if math.prod(spans) < 2 ** 62:
            packed = np.zeros(len(cols[0]), np.int64)
            for c, lo, span in zip(cols, lows, spans):
                packed = packed * span + (c - lo)
            _, inverse = np.unique(packed, return_inverse=True)
            return inverse.reshape(-1).astype(np.int64)
    stacked = np.stack(cols, axis=1)
    _, inverse = np.unique(stacked, axis=0, return_inverse=True)
    return inverse.reshape(-1).astype(np.int64)


@dataclass
class DataFormatter:
    """Shared formatting pipeline; subclasses implement prep_dataset/finalize."""

    intensity_key: Optional[str] = None
    uncertainty_key: Optional[str] = None
    image_key: Optional[str] = None
    metadata_keys: Sequence[str] = field(default_factory=lambda: ["dHKL"])
    separate_outputs: bool = False
    anomalous: bool = False
    dmin: Optional[float] = None
    isigi_cutoff: Optional[float] = None
    positional_encoding_keys: Optional[Sequence[str]] = None
    encoding_bit_depth: int = 4
    spacegroups: Optional[List[SpaceGroup]] = None
    standardize: bool = True

    # ------------------------------------------------------------- pipeline
    def get_data_and_asu_collection(self, datasets
                                    ) -> Tuple[DataSet, ReciprocalASUCollection]:
        frames = []
        cells, spacegroups = [], []
        for file_id, ds in enumerate(datasets):
            if self.spacegroups is not None:
                sg = self.spacegroups[file_id]
            elif ds.spacegroup is not None:
                sg = ds.spacegroup
            else:
                raise ValueError("Could not determine spacegroups. "
                                 "Please supply the --spacegroups flag")
            ds = self.prep_dataset(ds, sg)
            ds["file_id"] = np.int64(file_id)
            ds["asu_id"] = np.int64(file_id if self.separate_outputs else 0)
            frames.append(ds)
            cells.append(ds.cell)
            spacegroups.append(sg)
            if not _cell_compatible_with_spacegroup(ds.cell, sg):
                raise ValueError(
                    f"Spacegroup {sg} found to be incompatible with unit cell "
                    f"constants {ds.cell} cannot proceed.")
        data = concat_datasets(frames)
        dmin = float(data["dHKL"].min())
        reciprocal_asus = []
        if self.separate_outputs:
            for cell, sg in zip(cells, spacegroups):
                reciprocal_asus.append(
                    ReciprocalASU(cell, sg, dmin, self.anomalous))
        else:
            reciprocal_asus.append(
                ReciprocalASU(cells[0], spacegroups[0], dmin, self.anomalous))
        rac = ReciprocalASUCollection(reciprocal_asus)
        data["image_id"] = _ngroup(data["file_id"], data["image_id"])
        return data, rac

    def __call__(self, datasets, device: DeviceLike = None
                 ) -> Tuple[Inputs, ReciprocalASUCollection]:
        data, rac = self.get_data_and_asu_collection(datasets)
        return self.finalize(data, rac, device)

    def read_files(self, files: Sequence[str]) -> List[DataSet]:
        """The reflection files as DataSets, unformatted."""
        return [_load(f) for f in files]

    def format_files(self, files: Sequence[str], device: DeviceLike = None
                     ) -> Tuple[Inputs, ReciprocalASUCollection]:
        """Inputs on `device` (None: the card) and the ASU collection."""
        return self(self.read_files(files), device)

    # ------------------------------------------------------------ key logic
    def _resolve_keys(self, ds: DataSet) -> Tuple[str, str, str]:
        image_key = self.image_key or get_first_key_of_dtype(ds, "B")
        check_for_key_error(image_key, "Batch", "--image-key", ds)
        intensity_key = self.intensity_key or get_first_key_of_dtype(ds, "J")
        check_for_key_error(intensity_key, "Intensity", "--intensity-key", ds)
        uncertainty_key = self.uncertainty_key
        if uncertainty_key is None:
            for prefix in ["Sig", "SIG"]:
                if prefix + intensity_key in ds.columns:
                    uncertainty_key = prefix + intensity_key
        if uncertainty_key is None:
            uncertainty_key = get_first_key_of_dtype(ds, "Q")
        check_for_key_error(uncertainty_key, "Stddev", "--uncertainty-key", ds)
        return image_key, intensity_key, uncertainty_key

    def _finalize_metadata(self, data: DataSet) -> np.ndarray:
        data["dHKL"] = data["dHKL"].astype("float32") ** -2.0
        check_for_metadata_key_error(self.metadata_keys, data)
        metadata = data.to_numpy(list(self.metadata_keys), np.float32)
        if self.standardize:
            metadata = standardize_metadata(metadata, list(self.metadata_keys))
        if self.positional_encoding_keys is not None:
            to_encode = data.to_numpy(list(self.positional_encoding_keys),
                                      np.float32)
            encoded = positional_encoding(to_encode, self.encoding_bit_depth)
            metadata = np.concatenate((metadata, encoded), axis=1)
        return metadata


@dataclass
class MonoFormatter(DataFormatter):
    """Monochromatic pipeline."""

    @classmethod
    def from_parser(cls, parser) -> "MonoFormatter":
        pe_keys = (parser.positional_encoding_keys.split(",")
                   if parser.positional_encoding_keys else None)
        return cls(
            intensity_key=parser.intensity_key,
            uncertainty_key=parser.uncertainty_key,
            image_key=parser.image_key,
            metadata_keys=parser.metadata_keys.split(","),
            separate_outputs=parser.separate_files,
            anomalous=parser.anomalous,
            dmin=0.0 if parser.dmin is None else parser.dmin,
            isigi_cutoff=parser.isigi_cutoff,
            positional_encoding_keys=pe_keys,
            encoding_bit_depth=parser.positional_encoding_frequencies,
            spacegroups=_parse_spacegroups(parser.spacegroups,
                                           len(parser.reflection_files)),
            standardize=parser.standardize_metadata,
        )

    def prep_dataset(self, ds: DataSet, spacegroup: Optional[SpaceGroup] = None,
                     inplace: bool = True) -> DataSet:
        if not inplace:
            ds = ds.copy()
        if spacegroup is not None:
            ds.spacegroup = spacegroup
        ds.compute_dHKL(inplace=True)
        ds.drop_rows(ds["dHKL"] < (self.dmin or 0.0))
        ds.remove_absences(inplace=True)
        hkls = ds.get_hkls()
        ds["Hobs"], ds["Kobs"], ds["Lobs"] = hkls.T
        ds.hkl_to_asu(inplace=True, anomalous=self.anomalous)
        image_key, intensity_key, uncertainty_key = self._resolve_keys(ds)
        ds["intensity"] = ds[intensity_key].copy()
        ds["uncertainty"] = ds[uncertainty_key].copy()
        ds["image_id"] = ds[image_key].copy()
        if self.isigi_cutoff is not None:
            bad = ds["intensity"] / ds["uncertainty"] < self.isigi_cutoff
            ds.drop_rows(bad)
        return ds

    def finalize(self, data: DataSet, rac: ReciprocalASUCollection,
                 device: DeviceLike = None
                 ) -> Tuple[Inputs, ReciprocalASUCollection]:
        metadata = self._finalize_metadata(data)
        refl_id = rac.to_refl_id(data["asu_id"], data.get_hkls())
        inputs = Inputs.from_arrays(
            refl_id=refl_id,
            image_id=data["image_id"],
            file_id=data["file_id"],
            metadata=metadata,
            intensities=data["intensity"].astype(np.float32),
            uncertainties=data["uncertainty"].astype(np.float32),
            device=device,
        )
        return inputs, rac


@dataclass
class LaueFormatter(DataFormatter):
    """Polychromatic pipeline: each observation expanded to its harmonics
    out to dmin, the harmonics outside the wavelength band dropped, and the
    rows of one (image, central ray) grouped into a harmonic group whose
    intensity is the observation's."""

    wavelength_key: str = "Wavelength"
    lam_min: Optional[float] = None
    lam_max: Optional[float] = None

    @classmethod
    def from_parser(cls, parser) -> "LaueFormatter":
        lmin = lmax = None
        if parser.wavelength_range is not None:
            lmin, lmax = parser.wavelength_range
        pe_keys = (parser.positional_encoding_keys.split(",")
                   if parser.positional_encoding_keys else None)
        return cls(
            wavelength_key=parser.wavelength_key,
            intensity_key=parser.intensity_key,
            uncertainty_key=parser.uncertainty_key,
            image_key=parser.image_key,
            metadata_keys=parser.metadata_keys.split(","),
            separate_outputs=parser.separate_files,
            anomalous=parser.anomalous,
            lam_min=lmin,
            lam_max=lmax,
            dmin=parser.dmin,
            isigi_cutoff=parser.isigi_cutoff,
            positional_encoding_keys=pe_keys,
            encoding_bit_depth=parser.positional_encoding_frequencies,
            spacegroups=_parse_spacegroups(parser.spacegroups,
                                           len(parser.reflection_files)),
            standardize=parser.standardize_metadata,
        )

    def prep_dataset(self, ds: DataSet, spacegroup: Optional[SpaceGroup] = None,
                     inplace: bool = True) -> DataSet:
        """dmin defaults to the file's own, and the band to the file's own
        wavelengths."""
        if not inplace:
            ds = ds.copy()
        if spacegroup is not None:
            ds.spacegroup = spacegroup
        ds.compute_dHKL(inplace=True)
        dmin = self.dmin
        if dmin is None or dmin == 0.0:
            dmin = float(ds["dHKL"].min())
        lam_min = self.lam_min
        if lam_min is None:
            lam_min = float(ds[self.wavelength_key].min())
        lam_max = self.lam_max
        if lam_max is None:
            lam_max = float(ds[self.wavelength_key].max())

        ds = expand_harmonics(ds, dmin, self.wavelength_key)

        hkls = ds.get_hkls()
        ds["Hobs"], ds["Kobs"], ds["Lobs"] = hkls.T

        lam = ds[self.wavelength_key]
        ds.drop_rows((lam < lam_min) | (lam > lam_max))
        ds.remove_absences(inplace=True)
        ds.hkl_to_asu(inplace=True, anomalous=self.anomalous)

        image_key, intensity_key, uncertainty_key = self._resolve_keys(ds)
        ds["intensity"] = ds[intensity_key].copy()
        ds["uncertainty"] = ds[uncertainty_key].copy()
        ds["image_id"] = ds[image_key].copy()
        if self.isigi_cutoff is not None:
            bad = ds["intensity"] / ds["uncertainty"] < self.isigi_cutoff
            ds.drop_rows(bad)
        return ds

    def finalize(self, data: DataSet, rac: ReciprocalASUCollection,
                 device: DeviceLike = None
                 ) -> Tuple[Inputs, ReciprocalASUCollection]:
        """harmonic_id numbers the (image_id, H_0, K_0, L_0) groups in
        sorted order; each group's intensity and uncertainty are its first
        row's, packed by group id and padded to the row count with 1.0."""
        data = data.copy()
        data["harmonic_id"] = _ngroup(data["image_id"], data["H_0"],
                                      data["K_0"], data["L_0"])

        metadata = self._finalize_metadata(data)
        refl_id = rac.to_refl_id(data["asu_id"], data.get_hkls())

        harmonic_id = data["harmonic_id"]
        _, idx = np.unique(harmonic_id, return_index=True)
        iobs = data["intensity"].astype(np.float32)[idx]
        sigma = data["uncertainty"].astype(np.float32)[idx]
        n = len(refl_id)
        iobs = np.pad(iobs, (0, n - len(iobs)), constant_values=1.0)
        sigma = np.pad(sigma, (0, n - len(sigma)), constant_values=1.0)

        inputs = Inputs.from_arrays(
            refl_id=refl_id,
            image_id=data["image_id"],
            file_id=data["file_id"],
            metadata=metadata,
            intensities=iobs,
            uncertainties=sigma,
            wavelength=data[self.wavelength_key].astype(np.float32),
            harmonic_id=harmonic_id,
            device=device,
        )
        return inputs, rac

    def read_files(self, files: Sequence[str]) -> List[DataSet]:
        for file in files:
            if file.endswith(".stream"):
                raise ValueError(
                    "careless poly does not support .stream files. "
                    "Use careless mono instead.")
        return super().read_files(files)
