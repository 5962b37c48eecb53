"""The port's crystallography (careless_tpu_torch.xtal, io.asu) against the
JAX package's (careless_tpu.xtal, io.asu), on numpy inputs made from a seed.

Both are numpy, and the port's copies run the same arithmetic on arrays of
the same layout, so everything is compared exactly: unit-cell d-spacings;
for a sweep of space groups (a copy slip in the tables or the Hall parser
shows only for some groups) the operators, map_to_asu with and without
anomalous, is_absent, is_centric, epsilon, generate_reciprocal_asu and the
ASU's refl_id lookups; MTZ files written by each package and read by the
other, field for field, with and without M/ISYM; and the port's MTZ bytes
equal to the JAX writer's on the same table.
"""
import numpy as np
import pandas as pd
import pytest

import chip_smoke
from careless_tpu import xtal as jx
from careless_tpu.io import asu as jasu
from careless_tpu_torch import xtal as tx
from careless_tpu_torch.io import asu as tasu

# (ITA number, a cell of its lattice): P1, P21, C2, P212121, P43212,
# I4122, P63, R3 (hexagonal axes), P6522, F23, Ia-3d
GROUPS = [(1, (31.0, 37.0, 43.0, 81.0, 97.0, 103.0)),
          (4, (31.0, 37.0, 43.0, 90.0, 104.0, 90.0)),
          (5, (61.0, 37.0, 43.0, 90.0, 111.0, 90.0)),
          (19, (31.0, 37.0, 43.0, 90.0, 90.0, 90.0)),
          (96, (41.0, 41.0, 53.0, 90.0, 90.0, 90.0)),
          (98, (41.0, 41.0, 53.0, 90.0, 90.0, 90.0)),
          (173, (43.0, 43.0, 61.0, 90.0, 90.0, 120.0)),
          (146, (47.0, 47.0, 59.0, 90.0, 90.0, 120.0)),
          (179, (43.0, 43.0, 61.0, 90.0, 90.0, 120.0)),
          (196, (53.0, 53.0, 53.0, 90.0, 90.0, 90.0)),
          (230, (53.0, 53.0, 53.0, 90.0, 90.0, 90.0))]
P63_CELL = (40.0, 40.0, 60.0, 90.0, 90.0, 120.0)


def _hkl(seed, n=3000, hmax=12):
    rng = np.random.default_rng(seed)
    return rng.integers(-hmax, hmax + 1, (n, 3)).astype(np.int64)


def _jax_ds(cols, cell, sg, types_):
    return jx.DataSet(pd.DataFrame(cols), cell=jx.UnitCell(*cell),
                      spacegroup=jx.SpaceGroup.from_name(sg),
                      mtz_dtypes=dict(types_))


def _port_ds(cols, cell, sg, types_):
    return tx.DataSet(dict(cols), cell=tx.UnitCell(*cell),
                      spacegroup=tx.SpaceGroup.from_name(sg),
                      mtz_dtypes=dict(types_))


@pytest.mark.parametrize("_, cell", GROUPS)
def test_unit_cell_d_spacings(_, cell):
    hkl = _hkl(0)
    hkl = hkl[np.any(hkl != 0, axis=1)]
    assert np.array_equal(tx.UnitCell(*cell).compute_d(hkl),
                          jx.UnitCell(*cell).compute_d(hkl))
    assert np.array_equal(tx.UnitCell(*cell).reciprocal_metric_tensor(),
                          jx.UnitCell(*cell).reciprocal_metric_tensor())


@pytest.mark.parametrize("number, cell", GROUPS)
def test_space_group_queries(number, cell):
    t, j = tx.SpaceGroup.from_name(number), jx.SpaceGroup.from_name(number)
    assert t.xyz_ops() == j.xyz_ops()
    assert (t.number, t.hm, t.hall) == (j.number, j.hm, j.hall)
    hkl = _hkl(number)
    for anomalous in (False, True):
        for a, b in zip(t.map_to_asu(hkl, anomalous=anomalous),
                        j.map_to_asu(hkl, anomalous=anomalous)):
            assert np.array_equal(a, b)
    assert np.array_equal(t.is_absent(hkl), j.is_absent(hkl))
    assert np.array_equal(t.is_centric(hkl), j.is_centric(hkl))
    assert np.array_equal(t.epsilon(hkl), j.epsilon(hkl))
    for anomalous in (False, True):
        got = t.generate_reciprocal_asu(tx.UnitCell(*cell), 4.0, anomalous)
        want = j.generate_reciprocal_asu(jx.UnitCell(*cell), 4.0, anomalous)
        assert np.array_equal(got, want) and len(got) > 50


@pytest.mark.parametrize("number, cell", GROUPS[::2])
@pytest.mark.parametrize("anomalous", [False, True])
def test_reciprocal_asu_lookups(number, cell, anomalous):
    """The sorted packed keys give the pandas MultiIndex's ids, NaN where
    an index is not in the ASU; the collection's global ids over two
    ASUs, -1 where missing."""
    args = [(tx.UnitCell(*cell), tx.SpaceGroup.from_name(number)),
            (jx.UnitCell(*cell), jx.SpaceGroup.from_name(number))]
    t = tasu.ReciprocalASU(*args[0], 5.0, anomalous)
    j = jasu.ReciprocalASU(*args[1], 5.0, anomalous)
    for name in ("Hall", "centric", "multiplicity", "dHKL"):
        assert np.array_equal(getattr(t, name), getattr(j, name))
    rng = np.random.default_rng(number)
    queries = np.concatenate([t.Hall[rng.permutation(len(t.Hall))],
                              _hkl(number, 500)])
    assert np.array_equal(t.to_refl_id(queries), j.to_refl_id(queries),
                          equal_nan=True)
    tc = tasu.ReciprocalASUCollection([t, t])
    jc = jasu.ReciprocalASUCollection([j, j])
    asu_id = rng.integers(0, 2, len(queries))
    assert np.array_equal(tc.to_refl_id(asu_id, queries, allow_missing=True),
                          jc.to_refl_id(asu_id, queries, allow_missing=True))
    ids = rng.integers(0, tc.n_refl, 100)
    for a, b in zip(tc.to_asu_id_and_miller_index(ids),
                    jc.to_asu_id_and_miller_index(ids)):
        assert np.array_equal(a, b)


def _table(with_isym, seed=0):
    (cols, types_), _, _ = chip_smoke.synthetic_mtz(seed, 3000, 30, P63_CELL,
                                                    "P 63", 3.0)
    if not with_isym:
        cols = {k: v for k, v in cols.items() if k != "M/ISYM"}
        types_ = {k: v for k, v in types_.items() if k != "M/ISYM"}
    return cols, types_


@pytest.mark.parametrize("with_isym", [False, True])
def test_mtz_bytes_equal_the_jax_writer(tmp_path, with_isym):
    cols, types_ = _table(with_isym)
    tx.write_mtz(_port_ds(cols, P63_CELL, "P 63", types_),
                 str(tmp_path / "t.mtz"))
    jx.write_mtz(_jax_ds(cols, P63_CELL, "P 63", types_),
                 str(tmp_path / "j.mtz"))
    assert (tmp_path / "t.mtz").read_bytes() == \
        (tmp_path / "j.mtz").read_bytes()


@pytest.mark.parametrize("with_isym", [False, True])
def test_mtz_written_by_each_read_by_the_other(tmp_path, with_isym):
    """Field for field: columns, values, types, cell and space group."""
    cols, types_ = _table(with_isym, seed=1)
    tx.write_mtz(_port_ds(cols, P63_CELL, "P 63", types_),
                 str(tmp_path / "t.mtz"))
    jx.write_mtz(_jax_ds(cols, P63_CELL, "P 63", types_),
                 str(tmp_path / "j.mtz"))
    for t, j in ((tx.read_mtz(str(tmp_path / "j.mtz")),
                  jx.read_mtz(str(tmp_path / "t.mtz"))),
                 (tx.read_mtz(str(tmp_path / "t.mtz")),
                  jx.read_mtz(str(tmp_path / "j.mtz")))):
        assert t.columns == list(j.columns) and len(t) == len(j) == 3000
        for c in t.columns:
            assert t[c].dtype == j[c].to_numpy().dtype
            assert np.array_equal(t[c], j[c].to_numpy()), c
        assert t.mtz_dtypes == j.mtz_dtypes
        assert t.cell == tx.UnitCell(*j.cell.parameters)
        assert t.spacegroup.xyz_ops() == j.spacegroup.xyz_ops()
    # observed indices come back from M/ISYM; without it, as written
    got = tx.read_mtz(str(tmp_path / "t.mtz"))
    assert np.array_equal(got.get_hkls(),
                          np.stack([cols[k] for k in "HKL"], 1))


def test_dataset_rows_keep_their_order():
    """Dropping rows keeps the others in order (pandas' drop and
    reset_index), the DataSet's symmetry helpers equal the JAX
    DataSet's."""
    cols, types_ = _table(True, seed=2)
    t = _port_ds(cols, P63_CELL, "P 63", types_)
    j = _jax_ds(cols, P63_CELL, "P 63", types_)
    for ds in (t, j):
        ds.compute_dHKL()
        ds.label_centrics()
        ds.compute_multiplicity()
        ds.hkl_to_asu(anomalous=True)
    drop = t["dHKL"] < 5.0
    t.drop_rows(drop)
    j.drop(j.index[drop], inplace=True)
    j.reset_index(inplace=True, drop=True)
    assert t.columns == list(j.columns)
    for c in t.columns:
        assert np.array_equal(t[c], j[c].to_numpy()), c
    both = tx.concat_datasets([t, t.select(t["I"] > 1.0)])
    want = jx.concat_datasets([j, j[j["I"] > 1.0]], ignore_index=True)
    for c in both.columns:
        assert np.array_equal(both[c], want[c].to_numpy()), c
