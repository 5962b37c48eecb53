"""The port's conversion scripts (careless_tpu_torch/scripts/) against the
JAX package's (scripts/), on the CPU.

Each JAX script runs in this process through runpy.run_path with sys.argv
set (scripts/ is not changed); the port's module runs on the same files:
  - to_intensities, plain and --anomalous, on tests/test_torch_stats.py's
    merges: the same columns, types and rows, I bit for bit, SigI within
    rtol 1e-5 (the truncated-normal moments in two libraries' f32), the
    other columns bit for bit; on an anomalous file without --anomalous
    both raise KeyError 'F';
  - stack_intensities on a merged and an unmerged file (bit for bit), and
    its refusal of a file without a J column;
  - stream2mtz from a seeded stream (tests/test_torch_stream_xds.py's),
    with and without a cell;
  - precognition2mtz on seeded .ii/.inp files with duplicate (X, Y) spots,
    NaN cells and short rows, with and without BioCARS logs;
  - make_difference_map on a phase MTZ with a P column and F-model (some
    rows NaN, the rows shuffled) against an anomalous "on" file, with and
    without --positive: the rows in the same HKL order, values within
    rtol 1e-6;
  - plot_predictions' table against the script's `data` global;
  - stills2mtz's refusal without DIALS (its conversion, under a stand-in
    for DIALS, is held in tests/test_torch_stills.py).
"""
import os
import runpy
import sys

import numpy as np
import pytest

import chip_smoke
from careless_tpu.xtal import read_mtz as jax_read_mtz
from careless_tpu_torch.scripts import (make_difference_map,
                                        plot_predictions, precognition2mtz,
                                        stack_intensities, stills2mtz,
                                        stream2mtz, to_intensities)
from careless_tpu_torch.xtal import DataSet, read_mtz, write_mtz
from tests.test_torch_stats import merged_outputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return merged_outputs(str(tmp_path_factory.mktemp("scripts")))


def run_jax(name, argv, monkeypatch):
    """The JAX script run as __main__ with these arguments; its globals."""
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    return runpy.run_path(os.path.join(ROOT, "scripts", name),
                          run_name="__main__")


def same_mtz(want_path, got_path, rtol=None, exact=()):
    """Two MTZs read back through the JAX reader: the same columns, types
    and rows; values bit for bit, or within rtol except the `exact`
    columns."""
    want, got = jax_read_mtz(want_path), jax_read_mtz(got_path)
    assert list(got.columns) == list(want.columns)
    assert got.mtz_dtypes == want.mtz_dtypes
    assert len(got) == len(want) > 0
    assert got.cell.parameters == want.cell.parameters
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c].to_numpy()
        if rtol is None or c in exact:
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=c)
    return got


@pytest.mark.parametrize("anomalous", [False, True], ids=["plain", "anom"])
def test_to_intensities_matches(files, tmp_path, monkeypatch, anomalous):
    src = files["merged_anom" if anomalous else "merged"]
    flag = ["--anomalous"] if anomalous else []
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    run_jax("to_intensities", flag + [src, outs[0]], monkeypatch)
    ds = to_intensities.run(to_intensities.ArgumentParser().parse_args(
        flag + [src, outs[1]]), device="cpu")
    want = jax_read_mtz(outs[0])
    sig = [c for c in want.columns if c.startswith("SigI")]
    got = same_mtz(*outs, rtol=1e-5,
                   exact=[c for c in want.columns if c not in sig])
    assert ds.columns == list(got.columns)
    assert len(sig) == (2 if anomalous else 1)
    if anomalous:
        assert list(got.columns[:10]) == to_intensities.ANOM_KEY_ORDER


def test_to_intensities_refuses_an_anomalous_file_without_the_flag(
        files, tmp_path, monkeypatch):
    argv = [files["merged_anom"], str(tmp_path / "x.mtz")]
    with pytest.raises(KeyError, match="'F'"):
        run_jax("to_intensities", argv, monkeypatch)
    with pytest.raises(KeyError, match="'F'"):
        to_intensities.run(to_intensities.ArgumentParser().parse_args(argv),
                           device="cpu")


def test_to_intensities_entry_point_takes_the_card(files, tmp_path):
    """Without a device the entry point asks for the card, and without one
    it raises rather than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_intensities.main([files["merged"], str(tmp_path / "x.mtz")])


@pytest.mark.parametrize("which", ["merged", "inputs"])
def test_stack_intensities_matches(files, tmp_path, monkeypatch, which):
    src = files[which] if which == "merged" else files[which][0]
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    run_jax("stack_intensities", [src, outs[0]], monkeypatch)
    stack_intensities.main([src, outs[1]])
    got = same_mtz(*outs)
    assert set(got["icol_id"]) == {0}


def test_stack_intensities_refuses_a_file_without_intensities(
        files, tmp_path, monkeypatch):
    argv = [files["merged_anom"], str(tmp_path / "x.mtz")]
    with pytest.raises(ValueError, match="No objects to concatenate"):
        run_jax("stack_intensities", argv, monkeypatch)
    with pytest.raises(ValueError, match="No objects to concatenate"):
        stack_intensities.main(argv)


@pytest.mark.parametrize("cell", [[], ["-c", "80", "80", "39", "90", "90",
                                       "90"]], ids=["header", "cell"])
def test_stream2mtz_matches(tmp_path, monkeypatch, cell):
    stream = str(tmp_path / "sim.stream")
    chip_smoke.synthetic_stream(4, stream, 2400, 12,
                                (79.1, 79.1, 38.4, 90.0, 90.0, 90.0),
                                "P 43 21 2", 2.5)
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    run_jax("stream2mtz", [stream, "-g", "P 43 21 2", "-o", outs[0]] + cell,
            monkeypatch)
    stream2mtz.main([stream, "-g", "P 43 21 2", "-o", outs[1]] + cell)
    # the JAX package's native parser, where built, rounds the geometry
    # columns within 1 ulp of f32 of the Python parser's
    got = same_mtz(*outs, rtol=1e-6, exact=["H", "K", "L", "BATCH", "I",
                                            "SigI"])
    assert len(got) == 2400


def write_precognition(d, seed, n_files=2, logs=False):
    """Seeded .ii/.inp files (and BioCARS logs): duplicate (X, Y) spots,
    NaN cells, short rows and comments."""
    rng = np.random.default_rng(seed)
    ii, inp = [], []
    for f in range(n_files):
        n = 60
        xy = rng.integers(0, 12, (n, 2)) * 1.5
        rows = []
        for i in range(n):
            h, k, l_ = rng.integers(-9, 10, 3)
            vals = [str(h), str(k), str(l_), str(rng.integers(1, 4)),
                    f"{xy[i, 0]:.1f}", f"{xy[i, 1]:.1f}",
                    f"{rng.uniform(1.5, 9):.4f}",
                    f"{rng.uniform(0.95, 1.25):.5f}",
                    f"{rng.normal(100, 40):.3f}",
                    f"{rng.uniform(2, 9):.3f}"]
            if i % 11 == 3:
                vals[8] = "nan"
            if i % 13 == 5:
                vals = vals[:9]
            rows.append(" ".join(vals) + ("  # spot" if i % 7 == 0 else ""))
        path = d / f"sweep_{f}.ii"
        path.write_text("# precognition\n\n" + "\n".join(rows) + "\n")
        ii.append(str(path))
        cell = np.array([66.9, 66.9, 40.8, 90, 90, 120]) + rng.normal(
            0, 0.05, 6) * [1, 1, 1, 0, 0, 0]
        path = d / f"sweep_{f}.inp"
        path.write_text("Pixel 0.1 0.1\nCrystal " + " ".join(
            f"{c:.4f}" for c in cell) + " 173\n")
        inp.append(str(path))
    argv = ["--ii-files", *ii, "--inp-files", *inp]
    if logs:
        path = d / "run.log"
        header = "".join(f"# header {i}\n" for i in range(18))
        names = [p[:-4] for p in inp][::-1] + [str(d / "other")]
        path.write_text(header + "file\tdelay\n" + "".join(
            f"{n}\t{i}\n" for i, n in enumerate(names)))
        argv += ["--logs", str(path)]
    return argv


@pytest.mark.parametrize("logs", [False, True], ids=["order", "logs"])
def test_precognition2mtz_matches(tmp_path, monkeypatch, logs):
    argv = write_precognition(tmp_path, 7, logs=logs)
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    run_jax("precognition2mtz", argv + ["-o", outs[0]], monkeypatch)
    ds = precognition2mtz.run(precognition2mtz.ArgumentParser().parse_args(
        argv + ["-o", outs[1]]))
    got = same_mtz(*outs)
    assert len(got) < 120 and np.isnan(got["I"].to_numpy()).any()
    assert "Multiplicity" not in ds.columns


def test_precognition2mtz_takes_the_spacegroup_flag(tmp_path, monkeypatch):
    argv = write_precognition(tmp_path, 8, n_files=1) + ["-g", "P 63"]
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    run_jax("precognition2mtz", argv + ["-o", outs[0]], monkeypatch)
    precognition2mtz.main(argv + ["-o", outs[1]])
    same_mtz(*outs)


@pytest.fixture(scope="module")
def phase_mtz(files, tmp_path_factory):
    """A phase MTZ of 80 % of the merged reflections, shuffled, with
    F-model (NaN on five rows) and a P column that is not PHIF-model."""
    rng = np.random.default_rng(0)
    src = read_mtz(files["merged"])
    rows = rng.permutation(np.flatnonzero(rng.random(len(src)) < 0.8))
    fmodel = (src["F"][rows] * rng.uniform(0.8, 1.2, len(rows))).astype(
        np.float32)
    fmodel[:5] = np.nan
    ph = DataSet({"H": src["H"][rows], "K": src["K"][rows],
                  "L": src["L"][rows], "F-model": fmodel,
                  "PHIC": rng.uniform(-180, 180, len(rows)).astype(
                      np.float32)},
                 cell=src.cell, spacegroup=src.spacegroup,
                 mtz_dtypes={"H": "H", "K": "H", "L": "H", "F-model": "F",
                             "PHIC": "P"})
    path = str(tmp_path_factory.mktemp("phases") / "phases.mtz")
    write_mtz(ph, path)
    return path


@pytest.mark.parametrize("positive", [False, True], ids=["signed",
                                                         "positive"])
def test_make_difference_map_matches(files, phase_mtz, tmp_path, monkeypatch,
                                     positive):
    flag = ["--positive"] if positive else []
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    args = [files["merged"], files["merged_anom"], phase_mtz]
    run_jax("make_difference_map", args + ["-o", outs[0]] + flag,
            monkeypatch)
    make_difference_map.main(args + ["-o", outs[1]] + flag)
    got = same_mtz(*outs, rtol=1e-6, exact=["H", "K", "L"])
    assert "ScaledDeltaF" in got.columns
    assert ("PhiDeltaF" in got.columns) == positive
    assert 0 < len(got) < len(jax_read_mtz(files["merged"]))


def test_plot_predictions_table_matches(files, tmp_path, monkeypatch):
    argv = ["-n", "4"] + files["preds"]
    want = run_jax("plot_predictions",
                   ["--image", str(tmp_path / "jax.png")] + argv,
                   monkeypatch)["data"]
    png = str(tmp_path / "port.png")
    got = plot_predictions.run(plot_predictions.ArgumentParser().parse_args(
        ["--image", png] + argv))
    assert os.path.getsize(png) > 0
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        w = want[c].to_numpy()
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], w.astype(np.float64),
                                       rtol=1e-9, atol=1e-12)
        else:
            assert got[c].astype(str).tolist() == w.astype(str).tolist()


def test_stills2mtz_refuses_without_dials(tmp_path, monkeypatch):
    argv = [str(tmp_path / "x.refl"), str(tmp_path / "x.expt")]
    with pytest.raises(SystemExit) as want:
        run_jax("stills2mtz", argv, monkeypatch)
    with pytest.raises(SystemExit) as got:
        stills2mtz.main(argv)
    assert str(got.value) == str(want.value)
    assert "requires a DIALS/cctbx installation" in str(got.value)
