"""The port's statistics CLIs (careless_tpu_torch/stats/) against the JAX
package's (careless_tpu/stats/), on the same merged files, on the CPU.

A seeded P 63 MTZ of 4,000 observations (chip_smoke.synthetic_mtz, as
tests/test_torch_cli.py makes it), written as two files, is merged by the
port's CLI for 3 iterations with --anomalous --separate-files
--merge-half-datasets --half-dataset-repeats=2 --test-fraction=0.1, and
one file once more without --anomalous for the F/I paths. Each tool's
run_analysis runs in both packages on those files, with every flag set
that changes its path: the tables have the same columns and rows in the
same order, equal strings and ints, NaN in the same places, and floats
within rtol 1e-9 / atol 1e-12 (CCs, completeness, prior_b's fit) or
rtol 1e-6 (Rsplit, I/sigI: scipy's optimiser and f32 means); the -o CSVs
agree cell for cell under the same tolerances with identical headers;
the joined halves of make_halves_* agree row for row; rescale's and
filter_by_image_cc's MTZs read back through the JAX reader equal; the
history plot has the JAX plot's line labels and y data. The numpy copies
of pandas' group-by, merge and correlations are also held against pandas
on seeded tables with ties, NaN keys and degenerate groups.
"""
import argparse
import csv
import importlib
import os

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from careless_tpu.xtal import read_mtz as jax_read_mtz
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.stats import _lib
from careless_tpu_torch.xtal import DataSet, SpaceGroup, UnitCell, write_mtz

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,XDET"
FLAGS = ["--iterations=3", "--mlp-layers=2", "--disable-gpu",
         "--disable-progress-bar"]
XVAL = ["--anomalous", "--separate-files", "--merge-half-datasets",
        "--half-dataset-repeats=2", "--test-fraction=0.1"]
CC_TOL = dict(rtol=1e-9, atol=1e-12)
LOOSE_TOL = dict(rtol=1e-6, atol=0.0)


def merged_outputs(d):
    """The seeded inputs and the port's merges of them in directory d."""
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, CELL,
                                                    "P 63", 3.0)
    ds = DataSet(cols, cell=UnitCell(*CELL),
                 spacegroup=SpaceGroup.from_name("P 63"), mtz_dtypes=types_)
    inputs = [os.path.join(d, f) for f in ("a.mtz", "b.mtz")]
    for path in inputs:
        write_mtz(ds, path)
    anom, plain = os.path.join(d, "anom"), os.path.join(d, "plain")
    port_main(["mono", KEYS, *inputs, anom, *FLAGS, *XVAL])
    port_main(["mono", KEYS, inputs[0], plain, *FLAGS])
    return dict(
        inputs=inputs, xval=[f"{anom}_xval_{i}.mtz" for i in (0, 1)],
        preds=[f"{anom}_predictions_{i}.mtz" for i in (0, 1)],
        merged_anom=f"{anom}_0.mtz", merged=f"{plain}_0.mtz",
        history=f"{anom}_history.csv")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return merged_outputs(str(tmp_path_factory.mktemp("stats")))


def tools(name):
    return (importlib.import_module(f"careless_tpu.stats.{name}"),
            importlib.import_module(f"careless_tpu_torch.stats.{name}"))


def assert_same_table(want: pd.DataFrame, got: DataSet, tol):
    """Same columns and rows in order, equal strings and ints, NaN in the
    same places, floats within tol."""
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        w, g = want[c].to_numpy(), got[c]
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            w, g = w.astype(np.float64), g.astype(np.float64)
            assert np.array_equal(np.isnan(w), np.isnan(g)), c
            np.testing.assert_allclose(g, w, err_msg=c, **tol)
        else:
            assert w.astype(str).tolist() == g.astype(str).tolist(), c


def assert_same_csv(want_path, got_path, tol):
    with open(want_path, newline="") as f:
        want = list(csv.reader(f))
    with open(got_path, newline="") as f:
        got = list(csv.reader(f))
    assert got[0] == want[0]
    assert len(got) == len(want)
    for w_row, g_row in zip(want[1:], got[1:]):
        assert len(w_row) == len(g_row)
        for w, g in zip(w_row, g_row):
            if w == g:
                continue
            np.testing.assert_allclose(float(g), float(w), **tol)


def run_both(name, argv, tmp_path, tol, monkeypatch):
    """Both tools' tables and CSVs; the JAX tool's seaborn plot, which
    changes neither, is not drawn. A weighted CC is compared where the
    group is not degenerate, that is where the JAX tool's pearson CC of
    the same group (pandas' corr) is not NaN: there the port gives NaN and
    the JAX tool its rounding's noise."""
    jax_tool, port_tool = tools(name)
    if hasattr(jax_tool, "lineplot"):
        monkeypatch.setattr(jax_tool, "lineplot", lambda *a, **k: None)
    paths = [str(tmp_path / f"{who}.csv") for who in ("jax", "port")]
    args = jax_tool.ArgumentParser().parse_args(argv + ["-o", paths[0]])
    want = jax_tool.run_analysis(args)
    if getattr(args, "method", "").lower() == "weighted":
        pearson = jax_tool.run_analysis(jax_tool.ArgumentParser().parse_args(
            argv + ["-m", "pearson", "-o", str(tmp_path / "pearson.csv")]))
        for c in want.columns:
            if want[c].dtype.kind == "f":
                want.loc[pearson[c].isna().to_numpy(), c] = np.nan
        want.to_csv(paths[0])
    got = port_tool.run_analysis(
        port_tool.ArgumentParser().parse_args(argv + ["-o", paths[1]]))
    assert_same_table(want, got, tol)
    assert_same_csv(*paths, tol)
    return got


CASES = (
    [("cchalf", "xval", ["-m", m, "-b", "3"] + o, CC_TOL)
     for m in ("pearson", "spearman", "weighted")
     for o in ([], ["--overall"])]
    + [("cchalf", "xval", ["--use-structure-factors"], CC_TOL),
       ("cchalf", "xval", ["--use-structure-factors", "--overall", "-b",
                           "4"], CC_TOL)]
    # bins of one or two pairs: NaN and +-1 groups
    + [("cchalf", "xval", ["-m", m, "-b", "200"], CC_TOL)
       for m in ("pearson", "spearman", "weighted")]
    + [("ccanom", "xval", ["-m", m, "-b", "3"], CC_TOL)
       for m in ("weighted", "pearson", "spearman")]
    + [("ccanom", "xval", ["--overall"], CC_TOL),
       ("rsplit", "xval", ["-b", "4"], LOOSE_TOL),
       ("rsplit", "xval", ["-b", "4", "--overall"], LOOSE_TOL)]
    + [("ccpred", "preds", ["-m", m, "-b", "3"], CC_TOL)
       for m in ("weighted", "pearson", "spearman")]
    + [("ccpred", "preds", ["--overall"], CC_TOL)]
    + [("image_cc", "preds", ["-m", m], CC_TOL)
       for m in ("weighted", "pearson", "spearman")]
    + [("isigi", "preds", ["-b", "4"], LOOSE_TOL),
       ("isigi", "preds", ["--overall"], LOOSE_TOL),
       ("isigi", "merged", ["-b", "5", "--log"], LOOSE_TOL),
       ("isigi", "inputs", ["--intensity-key", "I", "--uncertainty-key",
                            "SigI"], LOOSE_TOL),
       ("completeness", "merged_anom", [], CC_TOL),
       ("completeness", "merged", ["-b", "5"], CC_TOL)])


@pytest.mark.parametrize(
    "name,which,argv,tol", CASES,
    ids=[f"{c[0]}-{c[1]}-{'_'.join(c[2]) or 'default'}" for c in CASES])
def test_tool_matches_the_jax_tool(files, tmp_path, monkeypatch, name, which,
                                  argv, tol):
    paths = files[which]
    run_both(name, (paths if isinstance(paths, list) else [paths]) + argv,
             tmp_path, tol, monkeypatch)


@pytest.mark.parametrize("name", ["cchalf", "rsplit", "ccanom"])
def test_joined_halves_match_row_for_row(files, name):
    jax_tool, port_tool = tools(name)
    want = getattr(jax_tool, f"make_halves_{name}")(
        jax_read_mtz(files["xval"][0]))
    got = getattr(port_tool, f"make_halves_{name}")(
        _lib.read_careless_mtz(files["xval"][0]))
    assert_same_table(want, got, dict(rtol=0, atol=0))


def test_stack_anomalous_matches(files):
    from careless_tpu.stats._lib import stack_anomalous
    want = stack_anomalous(jax_read_mtz(files["merged_anom"]))
    got = _lib.stack_anomalous(_lib.read_mtz(files["merged_anom"]))
    assert_same_table(want, got, dict(rtol=0, atol=0))


@pytest.mark.parametrize("argv", [[], ["-c", "9.0"], ["-d", "4.0"],
                                  ["-b", "7", "-s", "SIGI"]],
                         ids=["default", "isigi_cutoff", "dmin", "bins"])
def test_prior_b_matches(files, argv, capsys):
    jax_tool, port_tool = tools("prior_b")
    want = jax_tool.run_analysis(
        jax_tool.ArgumentParser().parse_args(files["inputs"] + argv))
    want_line = capsys.readouterr().out
    got = port_tool.run_analysis(
        port_tool.ArgumentParser().parse_args(files["inputs"] + argv))
    assert capsys.readouterr().out == want_line
    assert want_line.startswith("Estimated Wilson b-factor: ")
    for k in ("slope", "intercept", "rvalue", "stderr", "intercept_stderr"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   err_msg=k, **CC_TOL)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **CC_TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **CC_TOL)


def test_prior_b_cutoff_truncates(files):
    """The --isigi-cutoff case above drops the highest-resolution rows."""
    _, port_tool = tools("prior_b")
    full = port_tool.run_analysis(
        port_tool.ArgumentParser().parse_args(files["inputs"] + ["-d", "0"]))
    cut = port_tool.run_analysis(
        port_tool.ArgumentParser().parse_args(files["inputs"] + ["-c", "9"]))
    assert np.max(cut.x) < np.max(full.x)


def test_prior_b_reads_a_stream(tmp_path):
    """A .stream gives the fit of the MTZ stream2mtz writes from it (the
    JAX tool, which has no cell for a stream, runs on that MTZ)."""
    from careless_tpu_torch.scripts import stream2mtz
    jax_tool, port_tool = tools("prior_b")
    stream = str(tmp_path / "x.stream")
    chip_smoke.synthetic_stream(4, stream, 2400, 12,
                                (79.1, 79.1, 38.4, 90.0, 90.0, 90.0),
                                "P 43 21 2", 2.5)
    mtz = str(tmp_path / "x.mtz")
    stream2mtz.main([stream, "-g", "P 43 21 2", "-o", mtz])
    want = jax_tool.run_analysis(jax_tool.ArgumentParser().parse_args([mtz]))
    got = port_tool.run_analysis(
        port_tool.ArgumentParser().parse_args([stream]))
    for k in ("slope", "intercept", "stderr"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   **CC_TOL)


def _same_mtz(want_path, got_path):
    want, got = jax_read_mtz(want_path), jax_read_mtz(got_path)
    assert list(got.columns) == list(want.columns)
    assert got.mtz_dtypes == want.mtz_dtypes
    assert len(got) == len(want)
    for c in want.columns:
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(),
                                      err_msg=c)
    return got


@pytest.mark.parametrize("which", ["merged", "merged_anom"])
def test_rescale_matches(files, tmp_path, which):
    jax_tool, port_tool = tools("rescale")
    outs = [str(tmp_path / f"{who}.mtz") for who in ("jax", "port")]
    for tool, out in zip((jax_tool, port_tool), outs):
        tool.run_analysis(tool.ArgumentParser().parse_args(
            [files[which], out, "-b", "20"]))
    got = _same_mtz(*outs)
    d = got.compute_dHKL(inplace=False)["dHKL"].to_numpy(np.float64)
    src = jax_read_mtz(files[which])
    col = "F" if which == "merged" else "F(+)"
    ratio = got[col].to_numpy(np.float64) / src[col].to_numpy(np.float64)
    ok = np.isfinite(ratio)
    np.testing.assert_allclose(ratio[ok], np.exp(-20 / (4 * d[ok] ** 2)),
                               rtol=1e-6)


def test_filter_by_image_cc_matches(files, tmp_path):
    """A cut-off inside the images' CC range: the same rows of each data
    file kept, some dropped; prediction files in any order."""
    jax_tool, port_tool = tools("filter_by_image_cc")
    _, image_cc = tools("image_cc")
    ccs = image_cc.run_analysis(image_cc.ArgumentParser().parse_args(
        files["preds"] + ["-o", str(tmp_path / "cc.csv")]))["CCpred"]
    cutoff = float(np.median(ccs))
    argv = files["inputs"] + files["preds"][::-1] + ["-c", str(cutoff)]
    want = jax_tool.run_analysis(jax_tool.ArgumentParser().parse_args(
        argv + ["-o", str(tmp_path / "jax")]))
    got = port_tool.run_analysis(port_tool.ArgumentParser().parse_args(
        argv + ["-o", str(tmp_path / "port")]))
    assert len(got) == len(want) == 2
    kept = [len(_same_mtz(w, g)) for w, g in zip(want, got)]
    assert 0 < sum(kept) < 2 * 4000
    # the default names: <data>_filtered.mtz
    default = port_tool.run_analysis(port_tool.ArgumentParser().parse_args(
        argv[:1] + files["preds"] + ["-c", str(cutoff)]))
    assert default == [files["inputs"][0][:-4] + "_filtered.mtz"]
    _same_mtz(want[0], default[0])


def test_history_plot_matches(files, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jax_tool, port_tool = tools("history")
    lines = []
    for tool in (jax_tool, port_tool):
        plt.figure()
        tool.plot_history(files["history"])
        lines.append([(ln.get_label(), np.asarray(ln.get_ydata(), float),
                       ln.get_linestyle(), ln.get_color())
                      for ln in plt.gca().get_lines()])
        assert plt.gca().get_yscale() == "log"
        plt.close("all")
    want, got = lines
    assert [w[0] for w in want] == [g[0] for g in got]
    assert any(w[0].endswith("(Test)") for w in want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[1], w[1], rtol=1e-12)
        assert g[2:] == w[2:]
    out = str(tmp_path / "history.png")
    port_tool.main([files["history"], "-o", out])
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("name,which,argv", [
    ("cchalf", "xval", ["-b", "3"]), ("ccpred", "preds", ["-b", "3"]),
    ("isigi", "preds", ["-b", "3", "--log"]),
    ("completeness", "merged_anom", [])])
def test_image_is_written(files, tmp_path, name, which, argv):
    _, port_tool = tools(name)
    paths = files[which]
    png = str(tmp_path / "plot.png")
    port_tool.run_analysis(port_tool.ArgumentParser().parse_args(
        (paths if isinstance(paths, list) else [paths]) + argv
        + ["-o", str(tmp_path / "t.csv"), "-i", png]))
    assert os.path.getsize(png) > 0


def test_table_prints_without_output(files, capsys):
    _, port_tool = tools("cchalf")
    result = port_tool.run_analysis(port_tool.ArgumentParser().parse_args(
        files["xval"] + ["-b", "2"]))
    text = capsys.readouterr().out.splitlines()
    assert len(text) == len(result) + 1
    assert text[0].split() == ["file", "repeat", "Resolution", "Range",
                               "(Å)", "bin", "Spacegroup", "CChalf"]


@pytest.mark.parametrize("name", ["cchalf", "ccanom", "ccpred", "image_cc",
                                  "isigi", "rsplit", "completeness",
                                  "prior_b", "rescale", "history",
                                  "filter_by_image_cc"])
def test_parsers_take_the_jax_flags(name):
    jax_tool, port_tool = tools(name)

    def flags(p):
        return sorted((tuple(a.option_strings), a.dest, a.default, a.nargs,
                       tuple(a.choices or ()), a.required)
                      for a in p._actions
                      if not isinstance(a, argparse._HelpAction))
    assert flags(port_tool.ArgumentParser()) == flags(
        jax_tool.ArgumentParser())


# ------------------------------------------- the numpy copies of pandas
def _seeded_frame(seed, n=400):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 6, n).astype(np.float64)
    key[rng.random(n) < 0.05] = np.nan
    x = rng.integers(0, 8, n).astype(np.float64)   # ties
    y = x * 0.5 + rng.normal(size=n)
    y[rng.random(n) < 0.02] = 3.0
    const = np.where(key == 2, 1.5, x)             # a constant group
    return pd.DataFrame({
        "file": rng.choice(np.array(["b_x", "a", "B", "ab"]), n),
        "key": key, "k2": rng.integers(-2, 2, n).astype(np.int32),
        "x": x, "y": y, "c": const,
        "s1": rng.uniform(0.5, 2, n), "s2": rng.uniform(0.5, 2, n)})


def _port_table(df):
    return DataSet({c: df[c].to_numpy() for c in df.columns})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["pearson", "spearman", "weighted"])
@pytest.mark.parametrize("cols", [("x", "y"), ("c", "y")],
                         ids=["xy", "constant"])
def test_grouped_ccs_match_pandas(seed, method, cols):
    from careless_tpu.stats._lib import cc_funcs as jax_cc_funcs
    df = _seeded_frame(seed)
    keys = ["file", "key", "k2"]
    want = df.groupby(keys).apply(
        jax_cc_funcs(*cols, "s1", "s2")[method], include_groups=False)
    t = _port_table(df)
    g = _lib.GroupBy(t, keys)
    got = _lib.cc_funcs(*cols, "s1", "s2")[method](t, g)
    for k in keys:
        assert (g.key_values[k].astype(str).tolist()
                == want.index.get_level_values(k).to_numpy().astype(
                    str).tolist())
    w = want.to_numpy(np.float64, copy=True)
    if method == "weighted":
        # degenerate groups: NaN where pandas' corr gives NaN
        w[df.groupby(keys).apply(jax_cc_funcs(*cols)["pearson"],
                                 include_groups=False).isna().to_numpy()] \
            = np.nan
    assert np.isnan(w).any()
    assert np.array_equal(np.isnan(got), np.isnan(w))
    np.testing.assert_allclose(got, w, **CC_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_group_first_and_transform_match_pandas(seed):
    df = _seeded_frame(seed)
    df.loc[df.index[::7], "y"] = np.nan
    t = _port_table(df)
    g = _lib.GroupBy(t, ["key", "file"])
    first = df.groupby(["key", "file"]).first()
    np.testing.assert_array_equal(g.first(t["y"]), first["y"].to_numpy())
    np.testing.assert_array_equal(g.first(t["k2"]), first["k2"].to_numpy())
    by = _lib.GroupBy(t, ["k2"])
    np.testing.assert_array_equal(
        by.broadcast(by.min(t["x"]), len(t)),
        df.groupby("k2")["x"].transform("min").to_numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_inner_merge_matches_pandas(seed):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"h": rng.integers(0, 5, 60),
                         "r": rng.integers(0, 2, 60).astype(np.int32),
                         "v": rng.normal(size=60)})
    right = pd.DataFrame({"h": rng.integers(0, 5, 40),
                          "r": rng.integers(0, 2, 40).astype(np.int32),
                          "v": rng.normal(size=40), "w": np.arange(40)})
    want = pd.merge(left, right, on=["h", "r"], suffixes=("1", "2"))
    got = _lib.inner_merge(_port_table(left), _port_table(right), ["h", "r"])
    assert_same_table(want, got, dict(rtol=0, atol=0))


def test_every_stats_entry_point_has_a_port():
    """pyproject.toml: a careless-tpu-torch.<tool> entry point for each
    careless-tpu.<tool>, pointing at the port's module of the same name."""
    import tomllib
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    jax_tools = {k.split(".", 1)[1]: v for k, v in scripts.items()
                 if k.startswith("careless-tpu.")}
    assert len(jax_tools) == 12
    for tool, target in jax_tools.items():
        port = scripts[f"careless-tpu-torch.{tool}"]
        assert port == target.replace("careless_tpu.", "careless_tpu_torch.")
        module, func = port.split(":")
        assert callable(getattr(importlib.import_module(module), func))
