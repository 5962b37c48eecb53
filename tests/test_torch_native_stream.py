"""The port's native CrystFEL stream parser (careless_tpu_torch/xtal/
_native.py, its cpp/stream_parser.cc) against the JAX package's
(careless_tpu.xtal._native.parse_stream), on the CPU, bit for bit: arrays,
dtypes and cell, on seeded streams of chip_smoke.synthetic_stream and on
edge streams made by editing one (two unit-cell blocks, of which the first
wins; a crystal without astar/bstar/cstar lines, which carries over the
previous crystal's; a malformed reflection row and a short one; no indexed
reflections; a missing path). The JAX library is compiled from cpp/stream_parser.cc with
cpp/Makefile's flags into a temporary directory, and the JAX module is
pointed at it, so the test neither builds into careless_tpu/ nor reads a
library that `make -C cpp` may be writing at the same moment.

Also: the port's Python reader equals the JAX one on the streams it reads;
read_crystfel reports the parser that ran, falls back to the Python reader
(and warns) only where no compiler is found, and raises where the compiler
fails; the build's place, its hash and concurrent builds; and the three
paths that read a stream (the mono CLI, stream2mtz, prior_b) go through
the native parser.
"""
import contextlib
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from careless_tpu.xtal import _native as jnative
from careless_tpu.xtal import stream as jstream
from careless_tpu_torch.xtal import _native as tnative
from careless_tpu_torch.xtal import stream as tstream

ROOT = Path(__file__).resolve().parent.parent
CELL = (79.1, 79.1, 38.4, 90.0, 90.0, 90.0)
SPACEGROUP = "P 43 21 2"
MAKEFILE_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]


@contextlib.contextmanager
def jax_native_library(directory):
    """The JAX _native module loading a library compiled from
    cpp/stream_parser.cc into `directory`; yields False (the module left
    as it is) where no compiler is found."""
    cxx = tnative.compiler()
    if cxx is None:
        yield False
        return
    lib = Path(directory) / "_native_lib.so"
    subprocess.run([*cxx, *MAKEFILE_FLAGS, "-shared", "-o", str(lib),
                    str(ROOT / "cpp" / "stream_parser.cc")], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(lib))
        mp.setattr(jnative, "_lib", None)
        yield True


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")) as built:
        if not built:
            pytest.fail("no host C++ compiler: the JAX library cannot be "
                        "compiled")
        yield


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> path: two seeded streams and the edge streams made from the
    first by editing its text."""
    d = tmp_path_factory.mktemp("streams")
    paths = {"12 crystals": d / "a.stream", "100 crystals": d / "b.stream"}
    chip_smoke.synthetic_stream(4, str(paths["12 crystals"]), 2400, 12,
                                CELL, SPACEGROUP, 2.5)
    chip_smoke.synthetic_stream(7, str(paths["100 crystals"]), 20000, 100,
                                CELL, SPACEGROUP, 2.0)
    lines = paths["12 crystals"].read_text().splitlines()

    def write(name, new_lines):
        paths[name] = d / (name.replace(" ", "_") + ".stream")
        paths[name].write_text("\n".join(new_lines) + "\n")

    end_cell = lines.index("----- End unit cell -----")
    write("two cells", lines[:end_cell + 1] + [
        "----- Begin unit cell -----", "CrystFEL unit cell file version 1.0",
        "a = 50.00 A", "b = 50.00 A", "c = 60.00 A", "al = 90.00 deg",
        "be = 90.00 deg", "ga = 90.00 deg", "----- End unit cell -----"]
        + lines[end_cell + 1:])
    # the second crystal's astar, bstar, cstar lines dropped, or replaced
    # by the first crystal's
    vec = [i for i, s in enumerate(lines)
           if s.startswith(("astar =", "bstar =", "cstar ="))]
    first = dict(zip(vec[3:6], vec[0:3]))
    write("no vectors", [s for i, s in enumerate(lines) if i not in first])
    write("first vectors", [lines[first.get(i, i)]
                            for i in range(len(lines))])
    first_row = lines.index("Reflections measured after indexing") + 2
    write("malformed row", lines[:first_row] + [
        "   1    2    3     100.00      10.00 x"] + lines[first_row:])
    write("short row", lines[:first_row] + [
        "   1    2    3     100.00      10.00"] + lines[first_row:])
    write("no reflections", lines[:end_cell + 1])
    return {k: str(v) for k, v in paths.items()}


def _same_arrays(got, want):
    (g_arrays, g_cell), (w_arrays, w_cell) = got, want
    assert list(g_arrays) == list(w_arrays)
    for k, w in w_arrays.items():
        assert g_arrays[k].dtype == w.dtype, k
        assert np.array_equal(g_arrays[k], w), k
    assert g_cell == w_cell


def _same_dataset(got, want):
    """A port DataSet equal to a JAX (pandas) DataSet bit for bit."""
    assert got.columns == list(want.columns)
    for c in got.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        assert np.array_equal(got[c], w), c
    assert got.mtz_dtypes == want.mtz_dtypes
    assert got.cell.parameters == want.cell.parameters


@pytest.mark.parametrize("name", ["12 crystals", "100 crystals", "two cells",
                                  "no vectors", "malformed row", "short row"])
def test_native_parse_matches_the_jax_library(streams, jax_lib, name):
    got = tnative.parse_stream(streams[name])
    _same_arrays(got, jnative.parse_stream(streams[name]))
    arrays, cell = got
    # a row of fewer than nine numbers takes the rest from the next line
    # (strtod skips the newline), and the two make one row
    n = {"100 crystals": 20000, "short row": 2401}.get(name, 2400)
    assert len(arrays["H"]) == n
    assert arrays["BATCH"].max() == (99 if name == "100 crystals" else 11)
    assert cell == pytest.approx(CELL)   # "two cells": the first block


def test_a_crystal_without_vectors_keeps_the_previous_ones(streams):
    missing, _ = tnative.parse_stream(streams["no vectors"])
    first, _ = tnative.parse_stream(streams["first vectors"])
    whole, _ = tnative.parse_stream(streams["12 crystals"])
    crystal1 = whole["BATCH"] == 1
    for k in first:
        assert np.array_equal(missing[k], first[k]), k
    assert not np.array_equal(missing["s1x"][crystal1],
                              whole["s1x"][crystal1])
    assert np.array_equal(missing["s1x"][~crystal1], whole["s1x"][~crystal1])


@pytest.mark.parametrize("name", ["12 crystals", "two cells",
                                  "malformed row", "short row"])
def test_python_reader_matches_the_jax_python_reader(streams, name):
    got = tstream._read_crystfel_python(streams[name])
    _same_dataset(got, jstream._read_crystfel_python(streams[name]))
    assert len(got) == 2400   # rows of fewer than nine fields are skipped
    # the Python reader keeps the last cell block, the native parser the
    # first
    assert got.cell.parameters[0] == (50.0 if name == "two cells" else 79.1)


def test_errors_match_the_jax_library(streams, jax_lib, tmp_path):
    for path, message in ((streams["no reflections"],
                           "no indexed reflections"),
                          (str(tmp_path / "missing.stream"),
                           "cannot open")):
        with pytest.raises(ValueError, match=message) as got:
            tnative.parse_stream(path)
        with pytest.raises(ValueError, match=message) as want:
            jnative.parse_stream(path)
        assert str(got.value) == str(want.value)


def test_read_crystfel_reports_the_native_parser(streams, jax_lib):
    tstream.last_parser = None
    got = tstream.read_crystfel(streams["12 crystals"], SPACEGROUP)
    assert tstream.last_parser == "native"
    want = jstream.read_crystfel(streams["12 crystals"], SPACEGROUP)
    _same_dataset(got, want)


def test_no_compiler_falls_back_to_the_python_reader(streams, monkeypatch):
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.warns(UserWarning, match="no host C\\+\\+ compiler"):
        got = tstream.read_crystfel(streams["12 crystals"])
    assert tstream.last_parser == "python"
    _same_dataset(got, jstream._read_crystfel_python(streams["12 crystals"]))


def test_a_failing_compiler_raises(streams, monkeypatch, tmp_path):
    cxx = tmp_path / "broken-c++"
    cxx.write_text("#!/bin/sh\necho 'broken compiler: refused' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(tnative, "compiler", lambda: [str(cxx)])
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    tstream.last_parser = None
    with pytest.raises(RuntimeError,
                       match="(?s)stream parser failed.*refused"):
        tstream.read_crystfel(streams["12 crystals"])
    assert tstream.last_parser is None
    assert list((tmp_path / "build").iterdir()) == []


def test_compiler_lookup(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    gxx = tnative.compiler()
    monkeypatch.setenv("CXX", "g++ -Wextra")
    assert tnative.compiler()[1:] == ["-Wextra"]
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert tnative.compiler() == gxx   # c++, else g++
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX")
    assert tnative.compiler() is None


def test_build_place_and_concurrent_builds(monkeypatch, tmp_path):
    """The default place is build/careless_tpu_torch/<16 hex>/ in the
    checkout; four builds at once into an empty root leave one library
    and no temporary directory; another compiler is another hash."""
    assert tnative.BUILD_ROOT == ROOT / "build" / "careless_tpu_torch"
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    cxx = tnative.compiler()
    got = [None] * 4

    def one(i):
        got[i] = tnative.build(cxx)
    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(got)) == 1 and got[0].name == tnative.LIB_NAME
    assert [p.name for p in tmp_path.iterdir()] == [got[0].parent.name]
    assert len(got[0].parent.name) == 16
    assert (got[0].parent / "build.log").exists()
    assert tnative.build(cxx) == got[0]
    assert tnative._digest([*cxx, "-g0"]) != got[0].parent.name


def test_stream_paths_take_the_native_parser(streams, monkeypatch, tmp_path):
    """stream2mtz, prior_b and the mono CLI each read through it."""
    from careless_tpu_torch.main import main as cli_main
    from careless_tpu_torch.scripts import stream2mtz
    from careless_tpu_torch.stats import prior_b

    calls = []
    parse = tnative.parse_stream
    monkeypatch.setattr(tnative, "parse_stream",
                        lambda path: calls.append(path) or parse(path))
    stream = streams["12 crystals"]
    stream2mtz.main([stream, "-g", SPACEGROUP,
                     "-o", str(tmp_path / "x.mtz")])
    prior_b.run_analysis(prior_b.ArgumentParser().parse_args([stream]))
    times = cli_main(["mono", chip_smoke.STREAM_KEYS, stream,
                      str(tmp_path / "out"), f"--spacegroups={SPACEGROUP}",
                      "--iterations=2", "--disable-progress-bar",
                      "--disable-gpu", "--mlp-layers=2"])
    assert calls == [stream] * 3
    assert times["read_parser"] == "native" and times["read_s"] > 0
    assert times["setup_s"] >= times["read_s"]
