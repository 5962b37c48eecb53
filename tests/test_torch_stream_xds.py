"""The port's CrystFEL .stream reader (careless_tpu_torch.xtal.stream) and
XDS readers and xds2mtz (careless_tpu_torch.xtal.xds) against the JAX
package's, on the CPU, from seeded files: a stream of 12 crystals written
by chip_smoke.synthetic_stream, and INTEGRATE.HKL / XDS_ASCII.HKL files
written here with XDS' header and number formats.

The stream: the port's pure-Python reader equals the JAX package's bit for
bit (columns, dtypes, cell, MTZ types). The port's read_crystfel equals the
JAX package's bit for bit where both take their native parser (the JAX
library compiled from cpp/stream_parser.cc into a temporary directory, as
tests/test_torch_native_stream.py does); where the JAX library cannot be
built and the JAX reader is its Python one, the integer and intensity
columns equal exactly and the geometry columns within 1 ulp of f32 (C's
double arithmetic against numpy's). MonoFormatter from the stream gives
Inputs equal to the JAX package's. XDS: both file
types read column for column equal (names, order, dtypes, values, cell,
space group, MTZ types), and xds2mtz's MTZ equals the JAX one byte for
byte, with the header's cell and space group and with both overridden.
"""
import numpy as np
import pytest

import chip_smoke
from careless_tpu.io.formatter import MonoFormatter as JaxMono
from careless_tpu.parser import parser as jax_parser
from careless_tpu.xtal import stream as jstream
from careless_tpu.xtal import xds as jxds
from careless_tpu_torch.io.formatter import MonoFormatter as PortMono
from careless_tpu_torch.parser import parser as port_parser
from careless_tpu_torch.xtal import stream as tstream
from careless_tpu_torch.xtal import xds as txds
from tests.test_torch_native_stream import jax_native_library

CELL = (79.1, 79.1, 38.4, 90.0, 90.0, 90.0)
SPACEGROUP = "P 43 21 2"
GEOMETRY = ("s1x", "s1y", "s1z", "ewald_offset", "angular_ewald_offset",
            "Wavelength")


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "sim.stream"
    chip_smoke.synthetic_stream(4, str(path), 2400, 12, CELL, SPACEGROUP,
                                2.5)
    return str(path)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """Whether the JAX package's read_crystfel takes its native parser."""
    with jax_native_library(tmp_path_factory.mktemp("jax_native")) as built:
        yield built


def _same_dataset(got, want):
    """A port DataSet equal to a JAX (pandas) DataSet bit for bit."""
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        assert np.array_equal(got[c], w), c
    assert got.mtz_dtypes == want.mtz_dtypes
    assert (got.cell is None) == (want.cell is None)
    if got.cell is not None:
        assert got.cell.parameters == want.cell.parameters
    assert (got.spacegroup is None) == (want.spacegroup is None)
    if got.spacegroup is not None:
        assert got.spacegroup.xyz_ops() == want.spacegroup.xyz_ops()


def test_read_crystfel_matches_the_jax_python_reader(stream_file):
    got = tstream._read_crystfel_python(stream_file)
    _same_dataset(got, jstream._read_crystfel_python(stream_file))
    assert len(got) == 2400 and got["BATCH"].max() == 11
    assert got.cell.parameters == pytest.approx(CELL)
    assert np.abs(got["ewald_offset"]).max() < 0.05


def test_read_crystfel_matches_the_jax_reader(stream_file, jax_native):
    got = tstream.read_crystfel(stream_file)
    both_native = jax_native and tstream.last_parser == "native"
    want = jstream.read_crystfel(stream_file)
    assert got.columns == list(want.columns)
    for c in got.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        if c in GEOMETRY and not both_native:
            np.testing.assert_array_max_ulp(got[c], w, maxulp=1)
        else:
            assert np.array_equal(got[c], w), c


def test_mono_formatter_from_a_stream_matches_the_jax_package(stream_file):
    argv = ["mono", chip_smoke.STREAM_KEYS, stream_file, "out",
            f"--spacegroups={SPACEGROUP}"]
    t_inputs, t_rac = PortMono.from_parser(
        port_parser.parse_args(argv)).format_files([stream_file],
                                                   device="cpu")
    j_inputs, j_rac = JaxMono.from_parser(
        jax_parser.parse_args(argv)).format_files([stream_file])
    for name in ("refl_id", "image_id", "file_id", "metadata",
                 "intensities", "uncertainties"):
        got = getattr(t_inputs, name).numpy()
        want = np.asarray(getattr(j_inputs, name))
        assert got.shape == want.shape, name
        assert np.array_equal(got, want.astype(got.dtype)), name
    assert t_inputs.n_obs > 2000
    assert np.array_equal(t_rac.hkls, j_rac.hkls)


def _xds_records(rng, n, integrate):
    """Lines of XDS data records in XDS' own number formats."""
    hkl = rng.integers(-30, 31, (n, 3))
    iobs = rng.gamma(2.0, 500.0, n) - 50.0
    sig = np.sqrt(np.abs(iobs)) + 5.0
    x, y = rng.uniform(0, 3000, (2, n))
    z = rng.uniform(0.5, 360.5, n)
    lines = []
    for i in range(n):
        h, k, l = hkl[i]
        if integrate:
            lines.append(
                f"{h:6d}{k:6d}{l:6d}{iobs[i]:11.3E}{sig[i]:10.3E}"
                f"{x[i]:8.1f}{y[i]:8.1f}{z[i]:9.1f}"
                f"{rng.uniform(0.1, 1.0):10.5f}{rng.integers(1, 101):4d}"
                f"{rng.integers(0, 101):4d}{rng.integers(10, 2000):7d}"
                f"{x[i] + rng.normal():8.1f}{y[i] + rng.normal():8.1f}"
                f"{z[i] + rng.normal():9.1f}"
                f"{rng.integers(0, 3000):7d}{rng.integers(0, 3000):7d}"
                f"{rng.integers(0, 3000):7d}{rng.integers(0, 3000):7d}"
                f"{rng.uniform(-180, 180):8.2f}{1:3d}")
        else:
            lines.append(
                f"{h:6d}{k:6d}{l:6d}{iobs[i]:11.3E}{sig[i]:11.3E}"
                f"{x[i]:8.1f}{y[i]:8.1f}{z[i]:9.1f}"
                f"{rng.uniform(0.1, 1.0):10.5f}{rng.integers(1, 101):4d}"
                f"{rng.integers(-100, 101):5d}{rng.uniform(-180, 180):8.2f}")
    return lines


def _write_xds(path, integrate, seed, n=3000):
    rng = np.random.default_rng(seed)
    cell = "    78.900    78.900    38.100  90.000  90.000  90.000"
    if integrate:
        head = ["!OUTPUT_FILE=INTEGRATE.HKL      DATE= 1-Jan-2024",
                "!Generated by INTEGRATE ",
                "!SPACE_GROUP_NUMBER=   96",
                f"!UNIT_CELL_CONSTANTS={cell}",
                "!NUMBER_OF_ITEMS_IN_EACH_DATA_RECORD=21",
                "!H,K,L,IOBS,SIGMA,XCAL,YCAL,ZCAL,RLP,PEAK,CORR,MAXC,",
                "!             XOBS,YOBS,ZOBS,ALF0,BET0,ALF1,BET1,PSI,ISEG",
                "!END_OF_HEADER"]
    else:
        items = ["H", "K", "L", "IOBS", "SIGMA(IOBS)", "XD", "YD", "ZD",
                 "RLP", "PEAK", "CORR", "PSI"]
        head = ["!FORMAT=XDS_ASCII    MERGE=FALSE    FRIEDEL'S_LAW=TRUE",
                "!OUTPUT_FILE=XDS_ASCII.HKL        DATE= 1-Jan-2024",
                "!SPACE_GROUP_NUMBER=   96",
                f"!UNIT_CELL_CONSTANTS={cell}",
                f"!NUMBER_OF_ITEMS_IN_EACH_DATA_RECORD={len(items)}",
                *(f"!ITEM_{name}={i + 1}" for i, name in enumerate(items)),
                "!END_OF_HEADER"]
    lines = head + _xds_records(rng, n, integrate) + ["!END_OF_DATA"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("kind", ["integrate", "ascii"])
def test_xds_files_read_as_the_jax_package_reads_them(tmp_path, kind):
    path = _write_xds(tmp_path / f"{kind}.HKL", kind == "integrate", 3)
    assert txds.infer_file_type(path) == kind
    got = txds.read_hkl(path)
    want = jxds.read_hkl(path)
    _same_dataset(got, want)
    assert got.spacegroup.number == 96 and "BATCH" in got.columns
    ints = [c for c in got.columns if got[c].dtype == np.int64]
    assert ints and got["H"].dtype == np.int32


@pytest.mark.parametrize("case", ["header", "overridden"])
def test_xds2mtz_writes_the_jax_file_byte_for_byte(tmp_path, case):
    extra = (["-s", "P 43 21 2", "-c", "79", "79", "38", "90", "90", "90"]
             if case == "overridden" else [])
    for kind in ("integrate", "ascii"):
        path = _write_xds(tmp_path / f"{kind}.HKL", kind == "integrate", 5)
        outs = []
        for name, module in (("port", txds), ("jax", jxds)):
            out = str(tmp_path / f"{kind}_{name}.mtz")
            module.run(module.ArgumentParser().parse_args(
                [path, out, *extra]))
            with open(out, "rb") as f:
                outs.append(f.read())
        assert len(outs[0]) > 3000 * 12 * 4
        assert outs[0] == outs[1], kind
