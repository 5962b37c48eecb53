"""The held-out test fraction (careless_tpu_torch/io/manager.py's
splitters, Trainer.train's validation_data and NLL_val, the CLI's
--test-fraction) against careless_tpu, on the CPU.

The port's splitters hold out the JAX package's rows for the same seed,
row for row and field for field: mono and Laue, by reflection and by
image, Laue's groups renumbered and its intensities repacked, and the same
error for a mask that cuts a harmonic group. Training with held-out rows
gives the params and training history of training on the same rows
without them, bit for bit (NLL_val draws nothing from the training
generator), and NLL_val is the held-out NLL before each chunk, scaled by
the ratio of rows; each validation pass seeds its uniforms apart
(mix64). From the JAX run's parameters, made sharp so that the NLL no
longer depends on the draws, the port's NLL_val equals the JAX
package's at rtol 1e-5. The CLIs (`mono` and `poly --test-fraction=0.2
--iterations=3`, one run of each package) write the same files and
columns, the history's NLL_val included, and the same prediction rows,
the held-out ones last with test = 1; from the JAX run's parameters the
port's outputs match its files at rtol 1e-5, as in test_torch_cli.py.
"""
import types

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io.manager import DataManager as JDataManager
from careless_tpu.main import main as jax_main
from careless_tpu.models.base import Inputs as JInputs
from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.formatter import LaueFormatter, MonoFormatter
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import (flatten_params,
                                                         mix64)
from careless_tpu_torch.parser import parser as port_parser
from careless_tpu_torch.utils.params import params_from_jax
from careless_tpu_torch.xtal import concat_datasets, read_mtz
from tests.test_torch_cli import _same_file_sets, _unflatten
from tests.test_torch_laue_host import write_laue_mtz

torch.set_num_threads(2)

FIELDS = ("refl_id", "image_id", "file_id", "metadata", "intensities",
          "uncertainties", "wavelength", "harmonic_id")
CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)
MONO = ("mono", "dHKL,image_id,XDET")
POLY = ("poly", "dHKL,image_id,Wavelength,XDET,YDET")
FLAGS = ["--iterations=3", "--mlp-layers=2", "--disable-progress-bar",
         "--test-fraction=0.2", "--validation-frequency=2"]


def _managers(laue, seed=3, n=3000, n_refl=300, n_images=15, d=4):
    arrays, asu, _ = chip_smoke.build_problem(seed, n, n_refl, n_images, d,
                                              laue=laue)
    parser = types.SimpleNamespace(**{**chip_smoke.MONO_DEFAULTS,
                                      "mlp_layers": 2, "seed": seed})
    return (DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                        parser, device="cpu"),
            JDataManager(JInputs.from_arrays(*arrays), asu, parser))


def _same_rows(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.numpy().dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)


@pytest.mark.parametrize("by", ["refl", "image"])
@pytest.mark.parametrize("laue", [False, True])
def test_splits_pick_the_jax_rows(laue, by):
    """Two splits in a row (the generator advances alike), each half's
    every field equal to the JAX package's."""
    port, jax_dm = _managers(laue)
    for fraction in (0.3, 0.5):
        got = getattr(port, f"split_data_by_{by}")(fraction)
        want = getattr(jax_dm, f"split_data_by_{by}")(fraction)
        for g, w in zip(got, want):
            _same_rows(g, w)
        assert 0 < got[1].n_obs < port.inputs.n_obs
        assert got[0].n_obs + got[1].n_obs == port.inputs.n_obs
        if laue:
            for half in got:
                hid = half.harmonic_id.numpy()
                assert np.array_equal(np.unique(hid),
                                      np.arange(hid.max() + 1))
                assert np.all(half.intensities.numpy()[hid.max() + 1:]
                              == 1.0)


def test_a_mask_that_cuts_a_group_raises_as_jax():
    port, jax_dm = _managers(True)
    hid = port.inputs.harmonic_id.numpy()
    mask = np.zeros(len(hid), bool)
    group = np.flatnonzero(np.bincount(hid) > 1)[0]
    mask[np.flatnonzero(hid == group)[0]] = True
    with pytest.raises(ValueError) as got:
        port.split_laue_data_by_mask(mask)
    with pytest.raises(ValueError) as want:
        jax_dm.split_laue_data_by_mask(mask)
    assert str(got.value) == str(want.value)
    assert str(group) in str(got.value)


def test_plans_are_built_once_per_split():
    """Training, validation and the two prediction passes alternate
    between the halves; each half's planned copy is built once, at the
    global table sizes."""
    port, _ = _managers(False)
    train, test = port.split_data_by_refl(0.2)
    first = [port.planned_inputs(x) for x in (train, test)]
    again = [port.planned_inputs(x) for x in (train, test, train, test)]
    assert all(a is b for a, b in zip(again, first * 2))
    for planned in first:
        assert planned.inputs.plans.refl.starts.shape[0] == port.n_refl
        assert planned.inputs.plans.image.starts.shape[0] == port.n_images


@pytest.mark.parametrize("laue", [False, True])
def test_held_out_rows_leave_training_alone(laue):
    """Training on the train rows with the test rows as validation data
    gives the params and loss, NLL, KL and gradient-norm history of the
    same training without them, bit for bit; NLL_val holds the held-out
    NLL (validation_nll at the run's base key) times rows trained over
    rows held out, before each chunk of 4 steps."""
    port, _ = _managers(laue)
    train, test = port.split_data_by_refl(0.2)
    _, params, trainer = port.build_model()
    rows = port.planned_inputs(train).inputs
    held = port.planned_inputs(test).inputs
    runs = [trainer.train(params, seeded_generator(5, "cpu"), rows, 10,
                          chunk_size=4, device="cpu", validation_data=v,
                          validation_frequency=4) for v in (held, None)]
    (pv, hv), (pn, hn) = runs
    for (k, a), (_, b) in zip(flatten_params(pv), flatten_params(pn)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert list(hv) == list(hn) + ["NLL_val"]
    for k in hn:
        np.testing.assert_array_equal(hv[k], hn[k], err_msg=k)
    val = np.asarray(hv["NLL_val"])
    assert len(val) == 10 and np.isfinite(val).all()
    assert (val[:4] == val[0]).all() and (val[4:8] == val[4]).all()
    assert (val[8:] == val[8]).all() and len(set(val)) == 3
    base = int(torch.randint(0, 2 ** 32, (1,),
                             generator=seeded_generator(5, "cpu")).item())
    scale = rows.n_obs / held.n_obs
    assert val[0] == scale * trainer.validation_nll(params, held, base, 0)


def test_validation_passes_seed_their_uniforms_apart():
    """torch's CPU generator reads only the low 32 bits of a seed, and the
    keys of a run's validation passes differ only above them; the mix that
    seeds the uniforms' generator (mix64) gives each pass low bits of its
    own."""
    keys = [12345 | ((2 ** 30 + done) << 32) for done in range(0, 10000, 10)]
    assert len({k & 0xFFFFFFFF for k in keys}) == 1
    assert len({mix64(k) & 0xFFFFFFFF for k in keys}) == len(keys)
    a, b = (torch.rand(4, generator=seeded_generator(mix64(k), "cpu"))
            for k in keys[:2])
    assert not torch.equal(a, b)

@pytest.fixture(scope="module", params=["mono", "poly"])
def cli_runs(request, tmp_path_factory):
    """One JAX and one port run of the CLI with --test-fraction."""
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "mono":
        (cols, types_), _, _ = chip_smoke.synthetic_mtz(3, 4000, 40, CELL,
                                                        "P 63", 3.0)
        mtz = str(d / "in.mtz")
        jx.write_mtz(jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*CELL),
                                spacegroup=jx.SpaceGroup.from_name("P 63"),
                                mtz_dtypes=types_), mtz)
        kind, keys = MONO
    else:
        mtz = write_laue_mtz(d / "laue.mtz", 3)
        kind, keys = POLY
    jax_main([kind, keys, mtz, str(d / "jax"), *FLAGS])
    port_main([kind, keys, mtz, str(d / "port"), *FLAGS, "--disable-gpu"])
    return kind, keys, mtz, str(d / "jax"), str(d / "port")


def test_clis_write_the_same_files(cli_runs):
    """The same files, columns and prediction rows (the held-out rows
    last, test = 1); the history's columns end in NLL_val, repeated over
    each chunk of --validation-frequency steps."""
    _, _, _, jax_out, port_out = cli_runs
    _same_file_sets(jax_out, port_out)
    got, want = (read_mtz(x + "_predictions_0.mtz")
                 for x in (port_out, jax_out))
    test = got["test"]
    assert 0 < test.sum() < len(test)
    assert (np.diff(test) >= 0).all()
    history = pd.read_csv(port_out + "_history.csv")
    assert list(history.columns)[-1] == "NLL_val"
    val = history["NLL_val"].to_numpy()
    assert val[0] == val[1] != val[2]


def _split_outputs(kind, keys, mtz, jax_out):
    """The merged and prediction tables that the port computes from the
    JAX run's parameters on its own split of the rows."""
    args = port_parser.parse_args([kind, keys, mtz, "out", *FLAGS])
    formatter = LaueFormatter if kind == "poly" else MonoFormatter
    inputs, rac = formatter.from_parser(args).format_files([mtz],
                                                           device="cpu")
    dm = DataManager(inputs, rac, parser=args, device="cpu")
    train, test = dm.split_data_by_refl(args.test_fraction)
    model, params, _ = dm.build_model()
    params["posterior"] = params_from_jax(
        _unflatten(np.load(jax_out + "_structure_factor.npz")), "cpu")
    params["scaler"] = params_from_jax(
        _unflatten(np.load(jax_out + "_scale.npz")), "cpu")
    (merged,) = dm.get_results(
        model.posterior.distribution(params["posterior"]), inputs=train)
    preds = concat_datasets(
        next(dm.get_predictions(model, params, x, test_value=t))
        for t, x in enumerate((train, test)))
    return train, test, merged, preds


def test_outputs_from_the_jax_parameters_match(cli_runs):
    """Merged F from the train rows only (N counts them), and every
    prediction column, the held-out rows' included, at rtol 1e-5."""
    kind, keys, mtz, jax_out, _ = cli_runs
    train, test, merged, preds = _split_outputs(kind, keys, mtz, jax_out)
    for got, path in ((merged, "_0.mtz"), (preds, "_predictions_0.mtz")):
        want = read_mtz(jax_out + path)
        assert got.columns == want.columns and len(got) == len(want)
        for c in got.columns:
            np.testing.assert_allclose(got[c].astype(np.float32), want[c],
                                       rtol=1e-5, atol=0, err_msg=c)
    assert float(merged["N"].sum()) == train.n_obs
    n_test = (test.n_obs if kind == "mono"
              else int(test.harmonic_id.max()) + 1)
    assert int(preds["test"].sum()) == n_test



def test_nll_val_matches_jax_from_its_parameters(cli_runs, tmp_path):
    """NLL_val as each package's Trainer.train writes it before its first
    step (the held-out NLL times rows trained over rows held out), from
    the JAX run's parameters made sharp: the surrogate posterior's and the
    scale model's standard deviations pushed down to their epsilons, so
    that the NLL no longer depends on the draws. Each package scores its
    own split (the same rows, test_splits_pick_the_jax_rows); the two
    values agree at rtol 1e-5, and the held-out loss (NLL plus the KL) and
    the training rows' NLL scaled the other way stand well apart."""
    import jax

    from careless_tpu.io.formatter import (LaueFormatter as JLaue,
                                           MonoFormatter as JMono)
    from careless_tpu.parser import parser as jax_parser
    from careless_tpu.utils.checkpoint import load_params as jax_load

    kind, keys, mtz, jax_out, _ = cli_runs
    sharp = {}
    for part in ("scale", "structure_factor"):
        with np.load(f"{jax_out}_{part}.npz") as f:
            arrays = dict(f)
        if part == "scale":
            arrays["mlp/out/w"][:, 1] = 0.0
            arrays["mlp/out/b"][1] = -40.0
        else:
            arrays["scale_raw"][:] = -40.0
        sharp[part] = str(tmp_path / f"{part}.npz")
        np.savez(sharp[part], **arrays)
    argv = [kind, keys, mtz, "out", *FLAGS]

    jargs = jax_parser.parse_args(argv)
    jinputs, jrac = (JLaue if kind == "poly" else JMono).from_parser(
        jargs).format_files([mtz])
    jdm = JDataManager(jinputs, jrac, parser=jargs)
    jtrain, jtest = jdm.split_data_by_refl(jargs.test_fraction)
    _, jparams, jtrainer = jdm.build_model()
    jparams["scaler"] = jax_load(sharp["scale"], jparams["scaler"])
    jparams["posterior"] = jax_load(sharp["structure_factor"],
                                    jparams["posterior"])
    want = jtrainer.train(jparams, jax.random.PRNGKey(0), jtrain, 1,
                          validation_data=jtest, progress=False
                          )[1]["NLL_val"][0]

    args = port_parser.parse_args(argv)
    formatter = LaueFormatter if kind == "poly" else MonoFormatter
    inputs, rac = formatter.from_parser(args).format_files([mtz],
                                                           device="cpu")
    dm = DataManager(inputs, rac, parser=args, device="cpu")
    train, test = dm.split_data_by_refl(args.test_fraction)
    model, params, trainer = dm.build_model()
    for part, tree in (("scale", "scaler"),
                       ("structure_factor", "posterior")):
        params[tree] = params_from_jax(_unflatten(np.load(sharp[part])),
                                       "cpu")
    rows = dm.planned_inputs(train).inputs
    held = dm.planned_inputs(test).inputs
    got = trainer.train(params, seeded_generator(0, "cpu"), rows, 1,
                        device="cpu", validation_data=held
                        )[1]["NLL_val"][0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

    with torch.no_grad():
        loss = float(model.elbo(params, held, seeded_generator(1, "cpu"),
                                seed=1)[0])
        nll_rows = float(model.elbo(params, rows, seeded_generator(1, "cpu"),
                                    seed=1)[1]["NLL"])
    for wrong in (train.n_obs / test.n_obs * loss,
                  test.n_obs / train.n_obs * nll_rows):
        assert abs(wrong - want) > 1e-3 * abs(want)
