"""The port's Laue host path (careless_tpu_torch.utils.laue, LaueFormatter,
the Laue branch of DataManager.get_predictions) against the JAX package's,
on the CPU, from seeded Laue MTZ files (chip_smoke.synthetic_laue_mtz,
written by the JAX writer; a 40/40/60 A P 63 cell to 2.5 A and a band of
0.8-1.6 A, so that about 1 % of the harmonic groups hold two or more
harmonics).

calculate_harmonic and expand_harmonics equal column for column and bit
for bit (names, order, dtypes, values), with dmin given and absent. The
formatter's Inputs and ASU collection equal field for field, exactly, at
the CLI defaults and with --wavelength-range, --separate-files,
--anomalous and --positional-encoding-keys. poly refuses .stream input
with the JAX package's message. get_predictions on rows shuffled and
groups renumbered at random: the same table row for row, the identifying
columns exactly and the moments at rtol 1e-5 (both packages sum each
group's f32 per-row moments in f32, the JAX package by a scatter-add in
row order, the port by the run plan's shifted adds in chain order, which
differ by a few ulps; and the per-row moments come from two libraries'
f32 MLPs).
"""
import numpy as np
import pandas as pd
import pytest

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io.formatter import LaueFormatter as JaxLaue
from careless_tpu.io.manager import DataManager as JaxManager
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu.parser import parser as jax_parser
from careless_tpu.utils import laue as jlaue
from careless_tpu_torch.io.formatter import LaueFormatter as PortLaue
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.parser import parser as port_parser
from careless_tpu_torch.utils import laue as tlaue
from careless_tpu_torch.utils.params import params_from_jax
from careless_tpu_torch.xtal import DataSet, SpaceGroup, UnitCell

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
DMIN, BAND = 2.5, (0.8, 1.6)
KEYS = "dHKL,image_id,Wavelength,XDET,Hobs"
CASES = {
    "defaults": [],
    "wavelength_range": ["--wavelength-range", "0.9", "1.5"],
    "separate_files": ["--separate-files"],
    "anomalous": ["--anomalous"],
    "positional_encoding": ["--positional-encoding-keys=XDET,YDET", "-L",
                            "3"],
}


def laue_columns(seed, n_spots=4000, n_images=40):
    (cols, types_), _, _, harmonics = chip_smoke.synthetic_laue_mtz(
        seed, n_spots, n_images, CELL, "P 63", DMIN, BAND)
    return cols, types_, harmonics


def write_laue_mtz(path, seed, n_spots=4000):
    cols, types_, _ = laue_columns(seed, n_spots)
    jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                            spacegroup=jx.SpaceGroup.from_name("P 63"),
                            mtz_dtypes=types_), str(path))
    return str(path)


@pytest.fixture(scope="module")
def mtz_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("laue")
    return [write_laue_mtz(d / "a.mtz", 0), write_laue_mtz(d / "b.mtz", 1,
                                                           3000)]


def test_calculate_harmonic_matches_jax():
    rng = np.random.default_rng(0)
    hkl = rng.integers(-12, 13, (5000, 3))
    hkl[:7] = 0
    got = tlaue.calculate_harmonic(hkl)
    want = jlaue.calculate_harmonic(hkl)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() > 1


@pytest.mark.parametrize("dmin", [None, 3.0])
def test_expand_harmonics_matches_jax(dmin):
    cols, types_, _ = laue_columns(2, 2000, 10)
    port = DataSet(cols, cell=UnitCell(*CELL),
                   spacegroup=SpaceGroup.from_name("P 63"), mtz_dtypes=types_)
    jds = jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                     spacegroup=jx.SpaceGroup.from_name("P 63"),
                     mtz_dtypes=types_)
    got = tlaue.expand_harmonics(port, dmin)
    want = jlaue.expand_harmonics(jds, dmin)
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 1000
    for c in got.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        assert np.array_equal(got[c], w), c
    assert (got.get_hkls() != got.to_numpy(["H_0", "K_0", "L_0"])).any()


@pytest.mark.parametrize("case", list(CASES))
def test_laue_formatter_matches_the_jax_package(mtz_files, case):
    files = mtz_files if case == "separate_files" else mtz_files[:1]
    keys = KEYS + (",file_id" if case == "separate_files" else "")
    argv = ["poly", keys, *files, "out", *CASES[case]]
    t_inputs, t_rac = PortLaue.from_parser(
        port_parser.parse_args(argv)).format_files(files, device="cpu")
    j_inputs, j_rac = JaxLaue.from_parser(
        jax_parser.parse_args(argv)).format_files(files)
    for name in ("refl_id", "image_id", "file_id", "harmonic_id",
                 "wavelength", "metadata", "intensities", "uncertainties"):
        got = getattr(t_inputs, name).numpy()
        want = np.asarray(getattr(j_inputs, name))
        assert got.shape == want.shape, name
        assert np.array_equal(got, want.astype(got.dtype)), name
    hid = t_inputs.harmonic_id.numpy()
    sizes = np.bincount(hid)
    assert t_inputs.is_laue and t_inputs.n_obs > 2000
    assert (sizes >= 2).any() and sizes.min() >= 1
    assert len(t_rac) == len(j_rac) == (2 if case == "separate_files" else 1)
    for name in ("hkls", "centric", "multiplicity", "dHKL", "asu_ids",
                 "offsets"):
        assert np.array_equal(getattr(t_rac, name), getattr(j_rac, name)), \
            name


def test_poly_refuses_stream_input(tmp_path):
    stream = tmp_path / "x.stream"
    stream.write_text("")
    argv = ["poly", KEYS, str(stream), "out"]
    errors = []
    for formatter, parser in ((PortLaue, port_parser),
                              (JaxLaue, jax_parser)):
        with pytest.raises(ValueError) as info:
            formatter.from_parser(parser.parse_args(argv)).format_files(
                [str(stream)])
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "does not support .stream" in errors[0]


def test_get_predictions_on_a_shuffled_chain_layout(mtz_files):
    """Rows shuffled and group ids renumbered at random, so that the
    port's chain layout reorders both; groups of two or more harmonics
    present. Both packages' tables from the same parameters (the JAX
    package's initial ones, perturbed) agree row for row."""
    import jax

    argv = ["poly", KEYS, mtz_files[0], "out", "--mlp-layers=2"]
    j_args = jax_parser.parse_args(argv)
    j_in, j_rac = JaxLaue.from_parser(j_args).format_files(mtz_files[:1])
    rng = np.random.default_rng(7)
    n = j_in.refl_id.shape[0]
    hid = np.asarray(j_in.harmonic_id)
    n_groups = int(hid.max()) + 1
    relabel = rng.permutation(n_groups)
    rows = rng.permutation(n)
    iobs, sig = (np.asarray(a).copy() for a in (j_in.intensities,
                                                 j_in.uncertainties))
    iobs[relabel] = np.asarray(j_in.intensities)[:n_groups]
    sig[relabel] = np.asarray(j_in.uncertainties)[:n_groups]
    arrays = [np.asarray(a)[rows] for a in (j_in.refl_id, j_in.image_id,
                                            j_in.file_id, j_in.metadata)]
    arrays += [iobs, sig]
    wavelength = np.asarray(j_in.wavelength)[rows]
    harmonic_id = relabel[hid][rows]
    assert (np.bincount(harmonic_id) >= 2).sum() >= 10

    j_inputs = JInputs.from_arrays(*arrays, wavelength=wavelength,
                                   harmonic_id=harmonic_id)
    j_dm = JaxManager(j_inputs, j_rac, parser=j_args)
    j_model, j_params, _ = j_dm.build_model()
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), j_params)
    (want,) = j_dm.get_predictions(j_model, params, j_inputs)

    t_args = port_parser.parse_args(argv)
    t_inputs = Inputs.from_arrays(*arrays, wavelength=wavelength,
                                  harmonic_id=harmonic_id, device="cpu")
    t_dm = DataManager(t_inputs, j_rac, parser=t_args, device="cpu")
    t_model, _, _ = t_dm.build_model()
    planned = t_dm.planned_inputs()
    assert planned.groups is not None and not np.array_equal(
        planned.groups.numpy(), np.arange(n_groups))
    (got,) = t_dm.get_predictions(t_model, params_from_jax(params, "cpu"))

    assert got.columns == list(want.columns) and len(got) == n_groups
    for c in ("H", "K", "L", "asu_id", "image_id", "file_id", "test",
              "Iobs", "SigIobs"):
        assert np.array_equal(got[c], want[c].to_numpy()), c
    for c in ("Ipred", "SigIpred", "Scale", "SigScale"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=1e-5,
                                   atol=0, err_msg=c)
