"""The port's CLI over several devices (`--num-devices 2 --disable-gpu`:
two gloo ranks on the CPU, careless_tpu_torch.main.launch) against the
same command line on one device, on the CPU.

Four runs at 3 iterations, each in two spawned ranks: mono with
`--merge-half-datasets` in each `--xval-mode` (serial: each half sharded
like the main merge; parallel: a half to each rank), `poly` (Laue shards
cut at chain boundaries) and mono with `--shard-axis mc --mc-samples 2`
(a sample to each rank). Each writes the single-device run's files: the
same file set, columns, MTZ types and row counts, the identifying columns
equal, the values within tests/parallel/test_distributed.py's parameter
tolerance (rtol 5e-4, atol 1e-5; the history's metrics within its metric
tolerance, rtol 2e-4, atol 1e-4), since the sharded merge sums its
gradients in another order. Also: too many devices, an --mc-samples the
ranks cannot divide and a CUDA run without a card refuse before any rank
starts, with the JAX package's messages where it has one; a rank that
fails makes the run raise; and the flags the port refuses are the four
that steer only JAX.
"""
import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from careless_tpu_torch import main as cli
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.parser import parser as port_parser
from careless_tpu_torch.xtal import DataSet, SpaceGroup, UnitCell, read_mtz
from careless_tpu_torch.xtal import write_mtz
from tests.test_torch_laue_host import CELL as LAUE_CELL
from tests.test_torch_laue_host import laue_columns

torch.set_num_threads(2)

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,XDET"
POLY_KEYS = "dHKL,image_id,Wavelength,XDET,YDET"
FLAGS = ["--iterations=3", "--mlp-layers=2", "--disable-progress-bar",
         "--disable-gpu"]
RUNS = {
    "serial": ("mono", ["--merge-half-datasets", "--xval-mode=serial"]),
    "parallel": ("mono", ["--merge-half-datasets",
                          "--xval-mode=parallel"]),
    "poly": ("poly", []),
    "mc": ("mono", ["--shard-axis=mc", "--mc-samples=2"]),
}
# columns that name a row rather than hold a value: equal exactly
IDS = ("H", "K", "L", "repeat", "half", "asu_id", "image_id", "file_id",
       "test", "Iobs", "SigIobs")


@pytest.fixture(scope="module")
def mtz(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, CELL,
                                                    "P 63", 3.0)
    write_mtz(DataSet(cols, cell=UnitCell(*CELL),
                      spacegroup=SpaceGroup.from_name("P 63"),
                      mtz_dtypes=types_), str(d / "mono.mtz"))
    cols, types_, _ = laue_columns(3)
    write_mtz(DataSet(cols, cell=UnitCell(*LAUE_CELL),
                      spacegroup=SpaceGroup.from_name("P 63"),
                      mtz_dtypes=types_), str(d / "laue.mtz"))
    return {"mono": str(d / "mono.mtz"), "poly": str(d / "laue.mtz")}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request, mtz, tmp_path_factory):
    """(one device's output base, two ranks' output base, rank 0's
    timings) of RUNS[request.param]."""
    kind, flags = RUNS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    argv = [kind, POLY_KEYS if kind == "poly" else KEYS, mtz[kind]]
    port_main(argv + [str(d / "one"), *FLAGS, *flags])
    times = port_main(argv + [str(d / "two"), *FLAGS, *flags,
                              "--num-devices=2"])
    return str(d / "one"), str(d / "two"), times


def _suffixes(base):
    return sorted(p[len(base):] for p in glob.glob(base + "_*"))


def test_two_ranks_write_the_one_device_files(runs):
    one, two, times = runs
    assert _suffixes(two) == _suffixes(one)
    assert "_history.csv" in _suffixes(one) and times["steps"] == 3
    for suffix in _suffixes(one):
        if suffix.endswith(".mtz"):
            a, b = read_mtz(two + suffix), read_mtz(one + suffix)
            assert a.columns == b.columns and a.mtz_dtypes == b.mtz_dtypes
            assert len(a) == len(b) > 100, suffix
            for c in b.columns:
                x, y = np.asarray(a[c]), np.asarray(b[c])
                if c in IDS:
                    assert np.array_equal(x, y), (suffix, c)
                else:
                    np.testing.assert_allclose(x, y, rtol=5e-4, atol=1e-5,
                                               err_msg=f"{suffix} {c}")
        elif suffix.endswith(".npz"):
            with np.load(two + suffix) as a, np.load(one + suffix) as b:
                assert a.files == b.files
                for k in b.files:
                    np.testing.assert_allclose(a[k], b[k], rtol=5e-4,
                                               atol=1e-5,
                                               err_msg=f"{suffix} {k}")


def test_two_ranks_write_the_one_device_history(runs):
    one, two, _ = runs
    read = [np.genfromtxt(b + "_history.csv", delimiter=",", names=True)
            for b in (two, one)]
    assert read[0].dtype.names == read[1].dtype.names
    assert len(read[0]) == len(read[1]) == 3
    for name in read[1].dtype.names:
        np.testing.assert_allclose(read[0][name], read[1][name], rtol=2e-4,
                                   atol=1e-4, err_msg=name)


def test_xval_halves_are_each_ranks(runs):
    """The half merges' file holds every (repeat, half) once, each half's
    N its rows, whichever rank merged it; a run without
    --merge-half-datasets writes none."""
    one, two, _ = runs
    if not os.path.exists(one + "_xval_0.mtz"):
        assert not glob.glob(two + "_xval_*")
        return
    a, b = read_mtz(two + "_xval_0.mtz"), read_mtz(one + "_xval_0.mtz")
    tags = sorted(set(zip(a["repeat"].tolist(), a["half"].tolist())))
    assert tags == [(0, 0), (0, 1)]
    for r, h in tags:
        sel = (a["repeat"] == r) & (a["half"] == h)
        assert np.array_equal(a["N"][sel], b["N"][sel])


def _args(mtz, tmp_path, *flags):
    return port_parser.parse_args(["mono", KEYS, mtz["mono"],
                                   str(tmp_path / "out"), *flags])


def test_too_many_devices_refuse(mtz, tmp_path):
    n = os.cpu_count()
    with pytest.raises(ValueError, match=f"^requested {n + 1} devices but "
                       f"only {n} available$"):
        cli.run_careless(_args(mtz, tmp_path, f"--num-devices={n + 1}",
                               "--disable-gpu"))


def test_mc_samples_that_do_not_divide_refuse(mtz, tmp_path):
    with pytest.raises(ValueError, match="^mc_samples=3 must divide evenly "
                       "over 2 devices for MC-axis sharding$"):
        cli.run_careless(_args(mtz, tmp_path, "--num-devices=2",
                               "--disable-gpu", "--shard-axis=mc",
                               "--mc-samples=3"))


def test_cuda_ranks_without_a_card_refuse(mtz, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_careless(_args(mtz, tmp_path, "--num-devices=2"))


def test_a_failing_rank_fails_the_run(tmp_path):
    """Both ranks fail to read a file that is no MTZ: the run raises, and
    writes nothing."""
    bad = tmp_path / "bad.mtz"
    bad.write_bytes(b"not an mtz file")
    args = port_parser.parse_args(["mono", KEYS, str(bad),
                                   str(tmp_path / "out"), *FLAGS,
                                   "--num-devices=2"])
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="not an MTZ file"):
        cli.run_careless(args)
    assert not glob.glob(str(tmp_path / "out*"))


def test_only_the_jax_only_flags_are_refused():
    assert [flag for flag, _, _ in cli._UNPORTED] == [
        "--run-eagerly", "--platform", "--rng-impl", "--jax-debug"]
