"""The port's CLI (careless_tpu_torch.main, parser, io.manager outputs,
utils.checkpoint) against the JAX package's, on the CPU.

One JAX run (`careless_tpu.main mono ... --iterations=3 --anomalous
--mlp-layers=2`, a seeded P 63 MTZ of ~4k observations) and the same
command line through the port with --disable-gpu: the same five files, the
same columns, MTZ types and rows (merged (H, K, L), one prediction row per
observation in the same order), the same history columns and steps, and
the same npz keys. Then the JAX run's trained parameters, read back from
its npz files and carried into the port (utils/params.py), give through
the port's get_results (with the anomalous unstack) and get_predictions
the JAX run's merged and prediction MTZs' values at rtol 1e-5 (f32
moments computed by two libraries). The same for `poly` (one JAX and one
port run of `poly ... --iterations=3` on a seeded Laue MTZ with groups of
two or more harmonics, tests/test_torch_laue_host.py's): the same files,
the merged rows and one prediction row per harmonic group, and from the
JAX run's parameters the merged F and the prediction table row for row at
rtol 1e-5. Warm start: files written by either package load into the
other's parameter tree bit for bit; --scale-file with --freeze-scales
writes the scale file back bit for bit; a missing key or a wrong shape
raises the JAX package's error. Also: the parsed mono namespace's defaults
equal the JAX parser's; flags the port does not run raise
NotImplementedError naming themselves; the history CSV is pandas' to_csv.
--save-data-manager's pickle restores a manager whose Inputs (bit for
bit), merged results and predictions (from the run's parameter files)
equal the run's files; a manager holding a tensor refuses to pickle;
--profile-dir writes a Chrome trace that parses and names the ELBO's
operations.
"""
import glob
import json
import os
import pickle

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.main import main as jax_main
from careless_tpu.parser import parser as jax_parser
from careless_tpu.utils.checkpoint import load_params as jax_load_params
from careless_tpu_torch.io.formatter import LaueFormatter, MonoFormatter
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.main import run_careless, write_history
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.parser import parser as port_parser
from careless_tpu_torch.utils.checkpoint import load_params
from careless_tpu_torch.utils.params import params_from_jax
from careless_tpu_torch.xtal import read_mtz
from tests.test_torch_laue_host import write_laue_mtz

CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
KEYS = "dHKL,image_id,XDET"
FLAGS = ["--iterations=3", "--anomalous", "--mlp-layers=2",
         "--disable-progress-bar"]
SUFFIXES = ("_0.mtz", "_history.csv", "_predictions_0.mtz", "_scale.npz",
            "_structure_factor.npz")
POLY_KEYS = "dHKL,image_id,Wavelength,XDET,YDET"
POLY_FLAGS = ["--iterations=3", "--mlp-layers=2", "--disable-progress-bar"]
PARTS = ("scale", "structure_factor")
TREE = {"scale": "scaler", "structure_factor": "posterior"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, CELL,
                                                    "P 63", 3.0)
    mtz = str(d / "in.mtz")
    jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                            spacegroup=jx.SpaceGroup.from_name("P 63"),
                            mtz_dtypes=types_), mtz)
    jax_main(["mono", KEYS, mtz, str(d / "jax"), *FLAGS])
    port_main(["mono", KEYS, mtz, str(d / "port"), *FLAGS, "--disable-gpu"])
    return mtz, str(d / "jax"), str(d / "port")


@pytest.fixture(scope="module")
def poly_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("poly")
    mtz = write_laue_mtz(d / "laue.mtz", 3)
    jax_main(["poly", POLY_KEYS, mtz, str(d / "jax"), *POLY_FLAGS])
    times = port_main(["poly", POLY_KEYS, mtz, str(d / "port"), *POLY_FLAGS,
                       "--disable-gpu"])
    return mtz, str(d / "jax"), str(d / "port"), times


def _unflatten(npz) -> dict:
    """An npz of "/"-joined paths -> the nested dicts and lists."""
    tree = {}
    for key in npz.files:
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]

    def lists(n):
        if not isinstance(n, dict):
            return n
        if all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)


def _same_file_sets(jax_out, port_out, n_steps=3):
    for suffix in SUFFIXES:
        assert os.path.exists(jax_out + suffix)
        assert os.path.exists(port_out + suffix), suffix
    for suffix in ("_0.mtz", "_predictions_0.mtz"):
        t, j = read_mtz(port_out + suffix), read_mtz(jax_out + suffix)
        assert t.columns == j.columns and t.mtz_dtypes == j.mtz_dtypes
        assert len(t) == len(j) > 100
        assert t.spacegroup.xyz_ops() == j.spacegroup.xyz_ops()
        assert np.array_equal(t.get_hkls(), j.get_hkls())
    t, j = (read_mtz(x + "_predictions_0.mtz") for x in (port_out, jax_out))
    for c in ("asu_id", "image_id", "file_id", "test", "Iobs", "SigIobs"):
        assert np.array_equal(t[c], j[c]), c
    t, j = (pd.read_csv(x + "_history.csv") for x in (port_out, jax_out))
    assert list(t.columns) == list(j.columns) and len(t) == len(j) == n_steps
    assert np.isfinite(t.to_numpy()).all()
    for suffix in ("_scale.npz", "_structure_factor.npz"):
        t, j = np.load(port_out + suffix), np.load(jax_out + suffix)
        assert t.files == j.files, suffix
        for k in t.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype


def test_both_clis_write_the_same_files(runs):
    _, jax_out, port_out = runs
    _same_file_sets(jax_out, port_out)


def test_both_poly_clis_write_the_same_files(poly_runs):
    """One prediction row per harmonic group, in group order; N counts
    every expanded row."""
    mtz, jax_out, port_out, times = poly_runs
    _same_file_sets(jax_out, port_out)
    args = port_parser.parse_args(["poly", POLY_KEYS, mtz, "out",
                                   *POLY_FLAGS])
    inputs, _ = LaueFormatter.from_parser(args).format_files([mtz],
                                                             device="cpu")
    hid = inputs.harmonic_id.numpy()
    preds = read_mtz(port_out + "_predictions_0.mtz")
    assert len(preds) == hid.max() + 1 < inputs.n_obs
    assert float(read_mtz(port_out + "_0.mtz")["N"].sum()) == inputs.n_obs
    assert times["steps"] == 3 and all(
        times[k] >= 0 for k in ("build_s", "read_s", "format_s", "model_s",
                                "plans_s", "train_s", "output_s"))


def _outputs_from_jax_parameters(formatter, argv, mtz, jax_out):
    args = port_parser.parse_args(argv)
    inputs, rac = formatter.from_parser(args).format_files([mtz],
                                                           device="cpu")
    dm = DataManager(inputs, rac, parser=args, device="cpu")
    model, params, _ = dm.build_model()
    params["posterior"] = params_from_jax(
        _unflatten(np.load(jax_out + "_structure_factor.npz")), "cpu")
    params["scaler"] = params_from_jax(
        _unflatten(np.load(jax_out + "_scale.npz")), "cpu")
    (merged,) = dm.get_results(
        model.posterior.distribution(params["posterior"]))
    (preds,) = dm.get_predictions(model, params)
    for got, path in ((merged, "_0.mtz"), (preds, "_predictions_0.mtz")):
        want = read_mtz(jax_out + path)
        assert got.columns == want.columns and len(got) == len(want)
        for c in got.columns:
            np.testing.assert_allclose(got[c].astype(np.float32), want[c],
                                       rtol=1e-5, atol=0, err_msg=c)
    return merged, preds


def test_outputs_from_the_jax_parameters_match(runs):
    mtz, jax_out, _ = runs
    merged, preds = _outputs_from_jax_parameters(
        MonoFormatter, ["mono", KEYS, mtz, "out", *FLAGS], mtz, jax_out)
    assert any(c.endswith("(-)") for c in merged.columns)
    assert not any(c.endswith("(-)") for c in preds.columns)


def test_poly_outputs_from_the_jax_parameters_match(poly_runs):
    mtz, jax_out, _, _ = poly_runs
    _outputs_from_jax_parameters(
        LaueFormatter, ["poly", POLY_KEYS, mtz, "out", *POLY_FLAGS], mtz,
        jax_out)


def test_mono_defaults_parse_as_the_jax_parser(runs):
    mtz = runs[0]
    for argv in (["mono", KEYS, mtz, "out"],
                 ["mono", "dHKL", mtz, mtz, "o", "--mc-samples=2",
                  "--studentt-likelihood-dof=4", "--refine-uncertainties",
                  "--separate-files", "-c", "1.0", "--seed", "7"]):
        assert vars(port_parser.parse_args(argv)) == \
            vars(jax_parser.parse_args(argv))


@pytest.mark.parametrize("flag", [
    "--run-eagerly", "--platform=cpu", "--rng-impl=rbg", "--jax-debug"])
def test_unported_flags_raise_naming_themselves(runs, flag):
    args = port_parser.parse_args(["mono", KEYS, runs[0], "out", flag])
    with pytest.raises(NotImplementedError, match=flag.split("=")[0]):
        run_careless(args, device="cpu")


@pytest.fixture(scope="module")
def flag_run(runs, tmp_path_factory):
    """The port's run of `runs` with --save-data-manager and --profile-dir
    (3 steps, the CPU)."""
    d = tmp_path_factory.mktemp("flags")
    argv = ["mono", KEYS, runs[0], str(d / "port"), *FLAGS, "--disable-gpu",
            "--save-data-manager", f"--profile-dir={d / 'trace'}"]
    port_main(argv)
    return argv, str(d / "port"), str(d / "trace")


def _restored(flag_run):
    argv, out, _ = flag_run
    dm = DataManager.from_pickle(out + "_data_manager.pickle", "cpu")
    model, params, _ = dm.build_model()
    params["scaler"] = load_params(out + "_scale", params["scaler"])
    params["posterior"] = load_params(out + "_structure_factor",
                                      params["posterior"])
    return argv, out, dm, model, params


@pytest.mark.parametrize("part", ["inputs", "results", "predictions"])
def test_save_data_manager_restores_the_run(flag_run, part):
    """DataManager.from_pickle(<out>_data_manager.pickle, "cpu"): its
    Inputs are the formatter's bit for bit, and from the run's parameter
    files its get_results and get_predictions give the run's merged and
    prediction MTZs."""
    argv, out, dm, model, params = _restored(flag_run)
    assert dm.device == torch.device("cpu") and dm.parser.seed == 1234
    if part == "inputs":
        args = port_parser.parse_args(argv)
        inputs, _ = MonoFormatter.from_parser(args).format_files(
            args.reflection_files, device="cpu")
        for f in ("refl_id", "image_id", "file_id", "metadata",
                  "intensities", "uncertainties"):
            a, b = getattr(dm.inputs, f), getattr(inputs, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert dm.inputs.wavelength is None
        return
    if part == "results":
        (got,) = dm.get_results(model.posterior.distribution(
            params["posterior"]))
        want = read_mtz(out + "_0.mtz")
    else:
        (got,) = dm.get_predictions(model, params)
        want = read_mtz(out + "_predictions_0.mtz")
    assert got.columns == want.columns and len(got) == len(want) > 100
    for c in want.columns:
        np.testing.assert_array_equal(np.asarray(got[c], want[c].dtype),
                                      want[c], err_msg=c)


def test_data_manager_with_a_tensor_refuses_to_pickle(flag_run, tmp_path):
    _, _, dm, _, _ = _restored(flag_run)
    dm.cache = torch.zeros(3)
    path = tmp_path / "dm.pickle"
    with pytest.raises(pickle.PicklingError, match="tensor"):
        dm.to_pickle(str(path))
    assert not path.exists()


def test_profile_dir_writes_a_trace_of_the_elbo(flag_run):
    """One Chrome/TensorBoard trace in the directory, JSON, whose events
    name the ELBO's operations (the posterior's erfinv draw, the trunk's
    products, the plain gathers' indexing, a backward) and the training
    loop's spans (utils/spans.py), a careless.step and a careless.backward
    range each step."""
    (path,) = glob.glob(os.path.join(flag_run[2], "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    for op in ("aten::erfinv", "aten::mm", "aten::index",
               "autograd::engine::evaluate_function: ErfinvBackward0"):
        assert op in names, op
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    # FLAGS' 3 iterations
    assert ranges.count("careless.step") == ranges.count(
        "careless.backward") == 3


@pytest.mark.parametrize("part", PARTS)
def test_warm_start_loads_jax_files(runs, part):
    """A JAX-written _scale.npz / _structure_factor.npz loads into the
    port's tree of the same run's model, leaf for leaf bit for bit."""
    mtz, jax_out, _ = runs
    args = port_parser.parse_args(["mono", KEYS, mtz, "out", *FLAGS])
    inputs, rac = MonoFormatter.from_parser(args).format_files(
        [mtz], device="cpu")
    _, params, _ = DataManager(inputs, rac, parser=args,
                               device="cpu").build_model()
    path = f"{jax_out}_{part}.npz"
    loaded = load_params(path, params[TREE[part]])
    stored = np.load(path)
    flat = flatten_params(loaded)
    assert [k for k, _ in flat] == sorted(stored.files)
    for k, v in flat:
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), stored[k]), k


@pytest.mark.parametrize("part", PARTS)
def test_port_files_load_into_jax(runs, part):
    _, jax_out, port_out = runs
    like = _unflatten(np.load(f"{jax_out}_{part}.npz"))
    loaded = jax_load_params(f"{port_out}_{part}", like)
    stored = np.load(f"{port_out}_{part}.npz")
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(flat) == len(stored.files)
    for path, v in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert np.array_equal(np.asarray(v), stored[key]), key


def test_freeze_scales_keeps_the_scale_file(runs, tmp_path):
    """The "on" merge of a time-resolved pair: the scales of a first merge
    loaded and frozen, its structure factors as the start; the scale file
    written back is the loaded one bit for bit."""
    mtz, _, port_out = runs
    out = str(tmp_path / "warm")
    port_main(["mono", KEYS, mtz, out, *FLAGS, "--disable-gpu",
               f"--scale-file={port_out}_scale.npz", "--freeze-scales",
               f"--structure-factor-file={port_out}_structure_factor"])
    before, after = (np.load(f"{x}_scale.npz") for x in (port_out, out))
    assert before.files == after.files
    for k in before.files:
        assert before[k].tobytes() == after[k].tobytes(), k
    moved = np.load(f"{out}_structure_factor.npz")
    start = np.load(f"{port_out}_structure_factor.npz")
    assert any(not np.array_equal(moved[k], start[k]) for k in start.files)
    assert np.isfinite(pd.read_csv(out + "_history.csv").to_numpy()).all()


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_params_errors_as_jax(runs, tmp_path, fault):
    _, jax_out, _ = runs
    stored = dict(np.load(jax_out + "_scale.npz"))
    like_np = _unflatten(np.load(jax_out + "_scale.npz"))
    like = params_from_jax(like_np, "cpu")
    key = sorted(stored)[1]
    if fault == "missing":
        del stored[key]
    else:
        stored[key] = np.zeros(stored[key].shape + (2,), np.float32)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **stored)
    kind = KeyError if fault == "missing" else ValueError
    with pytest.raises(kind) as got:
        load_params(path, like)
    with pytest.raises(kind) as want:
        jax_load_params(path, like_np)
    assert str(got.value) == str(want.value)
    assert key in str(got.value)


def test_poly_runs_and_devices_lists(poly_runs, capsys):
    """poly runs through the port's CLI (poly_runs), and `devices` lists
    the CPU."""
    port_out = poly_runs[2]
    for suffix in SUFFIXES:
        assert os.path.exists(port_out + suffix), suffix
    assert run_careless(port_parser.parse_args(["devices"])) is None
    assert " - cpu" in capsys.readouterr().out


def test_history_csv_is_pandas_to_csv(tmp_path):
    history = {"loss": [1.5, float("nan"), 2.0 ** -30, 1e20],
               "F KLDiv": [0.1, 3.0, -7.25, float("inf")]}
    write_history(history, str(tmp_path / "t.csv"))
    pd.DataFrame(history).to_csv(tmp_path / "j.csv", index_label="step")
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()


@pytest.mark.parametrize("laue", [False, True])
def test_prediction_moments_match_jax(laue):
    """scale_mean_stddev and prediction_mean_stddev (variational.py:602-630)
    against the JAX model's on the same parameters, mono and Laue (the
    harmonic convolution). Mono: rtol 1e-5 with atol 1e-6 of each
    output's largest entry (f32 sums and the MLP in another order). Laue:
    the JAX package convolves through its plan by differencing f32 cumsums,
    the port by the run plan's shifted f32 adds, so both packages'
    convolved moments are held against an f64 sum over each
    harmonic group of the port's per-row moments, within 1e-5 of it plus
    2^-22 of the sum of the convolved values' magnitudes (a bound on a
    cumsum's rounding), the port no farther from it than the JAX package.
    predict_ipred's (S, N) samples are finite."""
    import dataclasses

    import jax
    import torch

    from careless_tpu.models.base import Inputs as JInputs
    from careless_tpu.models.likelihoods import laue as jlaue
    from careless_tpu.models.merging.variational import \
        VariationalMergingModel as JModel
    from careless_tpu_torch.device import seeded_generator
    from careless_tpu_torch.models.base import Inputs
    from careless_tpu_torch.models.likelihoods import laue as tlaue
    from tests.test_torch_elbo import _jax_parts, _torch_model

    n, n_refl, n_images, d, n_layers = 3000, 400, 9, 4, 3
    arrays, asu, _ = chip_smoke.build_problem(4, n, n_refl, n_images, d,
                                              laue=laue)
    prior, posterior, scaler = _jax_parts(asu.centric, n_layers, d, n_images)
    rng = np.random.default_rng(5)
    params = {"posterior": posterior.init(np.asarray(prior.mean()),
                                          np.asarray(prior.stddev())),
              "scaler": scaler.init(jax.random.PRNGKey(0), d)}
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), params)
    j_model = JModel(posterior=posterior, prior=prior,
                     likelihood=jlaue.NormalLikelihood() if laue else None,
                     scaler=scaler)
    t_model = _torch_model(asu.centric, n_layers, d, n_images)
    j_in = JInputs.from_arrays(*arrays)
    t_in = Inputs.from_arrays(*arrays, device="cpu")
    if laue:
        t_model = dataclasses.replace(t_model,
                                      likelihood=tlaue.NormalLikelihood())
        j_in = j_in.sorted_by_harmonic(n_refl)
        t_in = t_in.sorted_by_harmonic(n_refl)
    j_in = j_in.with_plans(n_refl, n_images, mlp_width=d)
    t_in = t_in.with_plans(n_refl, n_images)
    p = params_from_jax(params, "cpu")
    got = {name: [t.numpy() for t in getattr(t_model, name)(p, t_in)]
           for name in ("scale_mean_stddev", "prediction_mean_stddev")}
    want = {name: [np.asarray(t) for t in getattr(j_model, name)(
        jax.tree.map(np.asarray, params), j_in)] for name in got}
    if laue:
        with torch.no_grad():
            sd = t_model.scaler.apply(p["scaler"], t_in)
            q = t_model.posterior.distribution(p["posterior"])
            rid = t_in.refl_id.long()
            f2 = torch.square(q.mean()) + torch.square(q.stddev())
            iexp = sd.mean() * f2[rid]
            ivar = q.moment_4()[rid] * (torch.square(sd.mean())
                                        + torch.square(sd.stddev())) \
                - torch.square(iexp)
        hid = t_in.harmonic_id.numpy()

        def conv(x):
            return np.bincount(hid, weights=x.double().numpy(), minlength=n)
        rows = {"scale_mean_stddev": (sd.mean(), torch.square(sd.stddev())),
                "prediction_mean_stddev": (iexp, ivar)}
        for name, (mean, var) in rows.items():
            exact = [conv(mean), np.sqrt(conv(var))]
            for g, e, w, x in zip(got[name], exact, want[name], (mean, var)):
                bound = 1e-5 * np.abs(e) + 2.0 ** -22 * x.abs().sum().item()
                assert (np.abs(g - e) <= bound).all(), name
                assert (np.abs(w - e) <= bound).all(), name
                assert np.abs(g - e).max() <= np.abs(w - e).max(), name
    else:
        for name in got:
            for g, w in zip(got[name], want[name]):
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=name)
    ipred = dataclasses.replace(t_model, mc_samples=2).predict_ipred(
        p, t_in, seeded_generator(0, "cpu"), seed=3)
    assert ipred.shape == (2, n) and bool(torch.isfinite(ipred).all())
