"""Convert DIALS stills-process output (refl + expt files) to an MTZ with
geometric metadata (fixed-frame cartesian coordinates, Ewald offsets).

The port's scripts/stills2mtz: the same flags, the same refusal where
DIALS/cctbx (`dials.array_family.flex`, `dxtbx.model.experiment_list`)
cannot be imported, and past it the same conversion, into the port's numpy
DataSet (no pandas). Like the JAX script it computes no column that the
reflection table lacks: H, K, L, BATCH (DIALS's `id`), I, SigI (the square
root of the variance, NaN where that is negative), the x/y cal/obs
centroids, then cartesian_fixed_obs_{x,y,z} and cartesian_fixed_{x,y,z}
where present, ewald_offset from Rh where present, and
cartesian_delta_{x,y,z} where both cartesian sets are. The cell and space
group are the first experiment's crystal's.

    python -m careless_tpu_torch.scripts.stills2mtz x.refl x.expt -o x.mtz
"""
import argparse

import numpy as np

from ..xtal import DataSet, SpaceGroup, UnitCell, write_mtz


class ArgumentParser(argparse.ArgumentParser):
    def __init__(self):
        super().__init__(description=__doc__)
        self.add_argument("refl_file", help="DIALS .refl reflection table")
        self.add_argument("expt_file", help="DIALS .expt experiment list")
        self.add_argument("-o", "--out", default="stills.mtz")


def run(args):
    """Writes and returns the DataSet converted from the DIALS files."""
    try:
        from dials.array_family import flex
        from dxtbx.model.experiment_list import ExperimentListFactory
    except ImportError as e:
        raise SystemExit(
            "stills2mtz requires a DIALS/cctbx installation "
            f"(import failed: {e}). Install DIALS and re-run, or use "
            "scripts/stream2mtz for CrystFEL-processed stills.")

    table = flex.reflection_table.from_file(args.refl_file)
    elist = ExperimentListFactory.from_json_file(args.expt_file)
    crystal = elist[0].crystal
    cell = UnitCell(*crystal.get_unit_cell().parameters())
    sg = SpaceGroup.from_name(
        crystal.get_space_group().type().universal_hermann_mauguin_symbol())

    h = table["miller_index"].as_vec3_double().as_numpy_array().astype(
        np.int32)
    cal = table["xyzcal.px"].as_numpy_array()
    obs = table["xyzobs.px.value"].as_numpy_array()
    with np.errstate(invalid="ignore"):
        sig = table["intensity.sum.variance"].as_numpy_array() ** 0.5
    cols = {"H": h[:, 0], "K": h[:, 1], "L": h[:, 2],
            "BATCH": table["id"].as_numpy_array(),
            "I": table["intensity.sum.value"].as_numpy_array(),
            "SigI": sig, "xcal": cal[:, 0], "ycal": cal[:, 1],
            "xobs": obs[:, 0], "yobs": obs[:, 1]}
    for key in ("cartesian_fixed_obs", "cartesian_fixed"):
        if key in table:
            for ax, v in zip("xyz", table[key].as_numpy_array().T):
                cols[f"{key}_{ax}"] = v
    if "Rh" in table:
        cols["ewald_offset"] = table["Rh"].as_numpy_array()
    if "cartesian_fixed_obs_x" in cols and "cartesian_fixed_x" in cols:
        for ax in "xyz":
            cols[f"cartesian_delta_{ax}"] = (cols[f"cartesian_fixed_obs_{ax}"]
                                             - cols[f"cartesian_fixed_{ax}"])

    mtz_dtypes = {"H": "H", "K": "H", "L": "H", "I": "J", "SigI": "Q",
                  "BATCH": "B"}
    for c in cols:
        mtz_dtypes.setdefault(c, "R")
    ds = DataSet(cols, cell=cell, spacegroup=sg, mtz_dtypes=mtz_dtypes)
    write_mtz(ds, args.out)
    print(f"wrote {args.out} ({len(ds)} reflections)")
    return ds


def main(argv=None):
    run(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
