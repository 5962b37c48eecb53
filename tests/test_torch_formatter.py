"""The port's MonoFormatter (careless_tpu_torch.io.formatter) against the JAX
package's, from a seeded P 63 MTZ of ~4k observations (chip_smoke's
synthetic_mtz, written by the JAX writer): the Inputs and the ASU
collection equal field for field, exactly, at the CLI defaults and with
--positional-encoding-keys, --anomalous, --dmin, --isigi-cutoff and
--separate-files over two files. Each package parses the same command line
with its own parser.
"""
import numpy as np
import pandas as pd
import pytest

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io.formatter import MonoFormatter as JaxMono
from careless_tpu.parser import parser as jax_parser
from careless_tpu_torch.io.formatter import LaueFormatter as PortLaue
from careless_tpu_torch.io.formatter import MonoFormatter as PortMono
from careless_tpu_torch.io.formatter import _ngroup
from careless_tpu_torch.parser import parser as port_parser

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,Hobs,XDET,BG"
CASES = {
    "defaults": [],
    "positional_encoding": ["--positional-encoding-keys=XDET,YDET", "-L", "3"],
    "anomalous": ["--anomalous"],
    "dmin": ["--dmin=4.5"],
    "isigi_cutoff": ["--isigi-cutoff=1.5"],
    "separate_files": ["--separate-files"],
}


def _write(path, seed, n_obs=4000):
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(seed, n_obs, 40, CELL,
                                                    "P 63", 3.0)
    jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                            spacegroup=jx.SpaceGroup.from_name("P 63"),
                            mtz_dtypes=types_), str(path))
    return str(path)


@pytest.fixture(scope="module")
def mtz_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("formatter")
    return [_write(d / "a.mtz", 0), _write(d / "b.mtz", 1, 3000)]


@pytest.mark.parametrize("case", list(CASES))
def test_mono_formatter_matches_the_jax_package(mtz_files, case):
    files = mtz_files if case == "separate_files" else mtz_files[:1]
    keys = KEYS + (",file_id" if case == "separate_files" else "")
    argv = ["mono", keys, *files, "out", *CASES[case]]
    t_inputs, t_rac = PortMono.from_parser(
        port_parser.parse_args(argv)).format_files(files, device="cpu")
    j_inputs, j_rac = JaxMono.from_parser(
        jax_parser.parse_args(argv)).format_files(files)
    for name in ("refl_id", "image_id", "file_id", "metadata",
                 "intensities", "uncertainties"):
        got = getattr(t_inputs, name).numpy()
        want = np.asarray(getattr(j_inputs, name))
        assert got.shape == want.shape, name
        assert np.array_equal(got, want.astype(got.dtype)), name
    assert t_inputs.n_obs > 1000 and not t_inputs.is_laue
    assert len(t_rac) == len(j_rac) == (2 if case == "separate_files" else 1)
    for name in ("hkls", "centric", "multiplicity", "dHKL", "asu_ids",
                 "offsets"):
        assert np.array_equal(getattr(t_rac, name), getattr(j_rac, name)), \
            name
    for t, j in zip(t_rac, j_rac):
        assert (t.dmin, t.anomalous) == (j.dmin, j.anomalous)
        assert t.spacegroup.xyz_ops() == j.spacegroup.xyz_ops()


@pytest.mark.parametrize("span", [400, 2 ** 62])
def test_ngroup_numbers_groups_as_pandas(span):
    """Keys packed into one int64 (span 400) and keys too wide to pack,
    sorted as rows (span 2^62)."""
    rng = np.random.default_rng(0)
    file_id = rng.integers(0, 3, 5000)
    image_id = rng.integers(-5, span - 5, 5000)
    want = pd.DataFrame({"f": file_id, "i": image_id}).groupby(
        ["f", "i"]).ngroup().to_numpy()
    assert np.array_equal(_ngroup(file_id, image_id), want)


def test_stream_input_is_refused():
    """poly refuses .stream input before reading it, with the JAX
    package's message (mono reads it: tests/test_torch_stream_xds.py)."""
    with pytest.raises(ValueError, match=r"does not support \.stream"):
        PortLaue().format_files(["x.stream"], device="cpu")
