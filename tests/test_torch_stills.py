"""The port's stills2mtz (careless_tpu_torch/scripts/stills2mtz.py) against
the JAX package's scripts/stills2mtz, on the CPU, through chip_smoke's DIALS
stand-in (dials_stand_in: the six calls both scripts make, over an .npz
table and a JSON experiment list that synthetic_stills writes; it reads no
DIALS file, so real DIALS files are exercised by neither package's tests).

The JAX script runs in this process through runpy.run_path with sys.argv
set, as tests/test_torch_scripts.py runs the others:
  - for six column sets (all; Rh alone; both cartesian sets; one cartesian
    set with Rh; one cartesian set alone; the required columns only) in
    P 1 21 1, R 3 :H and P 43 21 2, with seeded negative variances (SigI
    NaN): the two MTZ files equal byte for byte, and read back the same
    columns, types and rows, every value bit for bit;
  - "I 1 2 1": both raise the same ValueError;
  - after the stand-in exits, `import dials` fails again and both scripts
    refuse as without it;
  - a merge of a small stills MTZ through both CLIs with the card phase's
    metadata keys (chip_smoke.STILLS_KEYS): the same files, MTZ columns
    and rows, and history columns.
"""
import filecmp
import importlib
import os

import pytest

import chip_smoke
from careless_tpu.main import main as jax_main
from careless_tpu_torch.main import main as port_main
from careless_tpu_torch.scripts import stills2mtz
from tests.test_torch_cli import _same_file_sets
from tests.test_torch_scripts import run_jax, same_mtz

CELLS = {"P 1 21 1": (64.5, 30.6, 34.9, 90.0, 105.5, 90.0),
         "R 3 :H": (80.0, 80.0, 100.0, 90.0, 90.0, 120.0),
         "P 43 21 2": (79.1, 79.1, 38.4, 90.0, 90.0, 90.0)}
COLUMN_SETS = {
    "all": chip_smoke.STILLS_COLUMNS, "rh": ("Rh",),
    "cartesian": ("cartesian_fixed_obs", "cartesian_fixed"),
    "obs_rh": ("cartesian_fixed_obs", "Rh"), "fixed": ("cartesian_fixed",),
    "required": ()}


def stills_files(tmp_path, spacegroup, columns, cell=None, **kw):
    refl, expt = str(tmp_path / "x.refl"), str(tmp_path / "x.expt")
    chip_smoke.synthetic_stills(7, refl, expt, kw.pop("n_refl", 600),
                                kw.pop("n_stills", 6),
                                cell or CELLS[spacegroup], spacegroup,
                                kw.pop("dmin", 3.0), columns, **kw)
    return refl, expt


def convert_both(refl, expt, tmp_path, monkeypatch):
    outs = [str(tmp_path / f"{w}.mtz") for w in ("jax", "port")]
    with chip_smoke.dials_stand_in():
        run_jax("stills2mtz", [refl, expt, "-o", outs[0]], monkeypatch)
        ds = stills2mtz.run(stills2mtz.ArgumentParser().parse_args(
            [refl, expt, "-o", outs[1]]))
    return outs, ds


@pytest.mark.parametrize("columns", COLUMN_SETS)
@pytest.mark.parametrize("spacegroup", CELLS)
def test_stills2mtz_matches(tmp_path, monkeypatch, spacegroup, columns):
    refl, expt = stills_files(tmp_path, spacegroup, COLUMN_SETS[columns])
    (want, got), ds = convert_both(refl, expt, tmp_path, monkeypatch)
    assert filecmp.cmp(want, got, shallow=False)
    back = same_mtz(want, got)
    assert len(back) == 600 and back["SigI"].isna().sum() == 8
    opt = set(COLUMN_SETS[columns])
    has = {k: k in opt for k in chip_smoke.STILLS_COLUMNS}
    assert ds.columns == (
        ["H", "K", "L", "BATCH", "I", "SigI", "xcal", "ycal", "xobs", "yobs"]
        + [f"{k}_{ax}" for k in ("cartesian_fixed_obs", "cartesian_fixed")
           if has[k] for ax in "xyz"]
        + ["ewald_offset"] * has["Rh"]
        + [f"cartesian_delta_{ax}" for ax in "xyz"
           if has["cartesian_fixed_obs"] and has["cartesian_fixed"]])
    assert back.mtz_dtypes == {
        c: {"H": "H", "K": "H", "L": "H", "I": "J", "SigI": "Q",
            "BATCH": "B"}.get(c, "R") for c in ds.columns}
    assert back.spacegroup.xyz_ops() == ds.spacegroup.xyz_ops()


def test_stills2mtz_refuses_the_same_space_group(tmp_path, monkeypatch):
    """I 1 2 1, a setting neither package's SpaceGroup.from_name takes."""
    refl, expt = stills_files(tmp_path, "P 1 21 1", ())
    with open(expt) as f:
        text = f.read()
    with open(expt, "w") as f:
        f.write(text.replace("P 1 21 1", "I 1 2 1"))
    argv = [refl, expt, "-o", str(tmp_path / "x.mtz")]
    with chip_smoke.dials_stand_in():
        with pytest.raises(ValueError) as want:
            run_jax("stills2mtz", argv, monkeypatch)
        with pytest.raises(ValueError) as got:
            stills2mtz.main(argv)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(argv[-1])


def test_stand_in_leaves_no_dials_behind(tmp_path, monkeypatch):
    with chip_smoke.dials_stand_in():
        importlib.import_module("dials.array_family.flex")
        importlib.import_module("dxtbx.model.experiment_list")
    for name in chip_smoke.DIALS_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(name)
    argv = [str(tmp_path / "x.refl"), str(tmp_path / "x.expt")]
    with pytest.raises(SystemExit) as want:
        run_jax("stills2mtz", argv, monkeypatch)
    with pytest.raises(SystemExit) as got:
        stills2mtz.main(argv)
    assert str(got.value) == str(want.value)
    assert "requires a DIALS/cctbx installation" in str(got.value)


def test_both_clis_merge_the_stills(tmp_path, monkeypatch):
    refl, expt = stills_files(tmp_path, "P 1 21 1", chip_smoke.STILLS_COLUMNS,
                              n_refl=4000, n_stills=40, negative=0)
    (mtz, _), _ = convert_both(refl, expt, tmp_path, monkeypatch)
    flags = ["--spacegroups=P 1 21 1", "--iterations=3",
             "--disable-progress-bar"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(["mono", chip_smoke.STILLS_KEYS, mtz, jax_out, *flags])
    port_main(["mono", chip_smoke.STILLS_KEYS, mtz, port_out, *flags,
               "--disable-gpu"])
    _same_file_sets(jax_out, port_out)
