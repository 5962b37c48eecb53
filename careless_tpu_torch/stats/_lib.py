"""Shared machinery for the port's statistics CLIs (numpy and scipy only).

Counterpart of careless_tpu/stats/_lib.py, whose tools are pandas and
seaborn. Every tool reads careless output MTZs into the port's numpy
DataSet, bins by resolution percentiles, groups rows, applies a CC or
summary function to each group, prints or saves the table, and draws it
with matplotlib when -i or -s asks for a plot. A table here is a DataSet
without crystallographic context: ordered, equal-length numpy columns.

The pandas operations the JAX tools use have numpy copies here:
  - GroupBy: `df.groupby(keys)`, groups sorted by their keys (numbers
    ascending, strings by code point), each group's rows in table order,
    rows with a NaN key dropped; one stable lexsort and segment bounds;
  - inner_merge: `pd.merge(left, right, on=keys)`, each left row in order
    joined to its matching right rows in order;
  - dropna: rows holding no NaN in any float column;
  - cc_funcs: `DataFrame.corr` (pearson, spearman) and weighted_pearsonr
    per group, vectorised over the segments;
  - emit: `DataFrame.to_csv` (a leading unnamed index column, NaN as an
    empty cell), or a plain fixed-width table without -o.
"""
from __future__ import annotations

import argparse
import csv
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..xtal import DataSet, concat_datasets, read_mtz


class BaseParser(argparse.ArgumentParser):
    """Common flags (careless_tpu/stats/_lib.py BaseParser)."""

    def __init__(self, **kwargs):
        super().__init__(formatter_class=argparse.RawTextHelpFormatter, **kwargs)
        self.add_argument("-s", "--show", action="store_true",
                          help="Make a plot of the results and display it "
                               "using matplotlib.")
        self.add_argument("-i", "--image", type=str, default=None,
                          help="Make a plot of the results and save it to "
                               "this filename.")
        self.add_argument("-o", "--output", type=str, default=None,
                          help="Optionally save results to this file in csv "
                               "format instead of printing them.")
        self.add_argument("-l", "--ylim", type=float, nargs=2, default=None,
                          help="Override the y-axis limits like `--ylim 0. 1.`")
        self.add_argument("--height", default=6, type=float,
                          help="Height of the plot (inches, default 6).")
        self.add_argument("--width", default=6, type=float,
                          help="Width of the plot (inches, default 6).")


def bin_by_percentile(data, bins: int = 10, ascending: bool = False):
    """Assign percentile bins; returns (labels, edges)
    (rs.utils.bin_by_percentile semantics)."""
    data = np.asarray(data, dtype=np.float64)
    qs = np.linspace(0, 100, bins + 1)
    edges = np.percentile(data, qs)
    if not ascending:
        edges = edges[::-1]
        labels = (bins - 1) - np.clip(
            np.searchsorted(edges[::-1], data, side="left") - 1, 0, bins - 1)
    else:
        labels = np.clip(np.searchsorted(edges, data, side="right") - 1,
                         0, bins - 1)
    return labels.astype(np.int64), edges


def weighted_pearsonr(x, y, w):
    """Weighted Pearson correlation (rs.utils.weighted_pearsonr)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    w = np.asarray(w, np.float64)
    sw = w.sum()
    mx = (w * x).sum() / sw
    my = (w * y).sum() / sw
    cov = (w * (x - mx) * (y - my)).sum() / sw
    vx = (w * np.square(x - mx)).sum() / sw
    vy = (w * np.square(y - my)).sum() / sw
    denom = np.sqrt(vx * vy)
    if denom == 0.0:  # zero-variance group: correlation undefined
        return np.nan
    return cov / denom


def resolution_labels(edges) -> List[str]:
    return [f"{e1:0.2f} - {e2:0.2f}" for e1, e2 in zip(edges[:-1], edges[1:])]


def sg_name(ds: DataSet) -> str:
    sg = ds.spacegroup
    if sg is None:
        return "unknown"
    return sg.hm or sg.hall or f"{sg.n_ops} ops"


# ------------------------------------------------------------------ tables
def table(columns: Dict[str, np.ndarray], like: Optional[DataSet] = None
          ) -> DataSet:
    """A DataSet of these columns, with `like`'s context if given."""
    if like is None:
        return DataSet(columns)
    return DataSet(columns, cell=like.cell, spacegroup=like.spacegroup,
                   mtz_dtypes=like.mtz_dtypes)


def pick(ds: DataSet, keys: Sequence[str],
         rename: Optional[Dict[str, str]] = None) -> DataSet:
    """The named columns in this order (pandas' `df[keys].rename(...)`)."""
    rename = rename or {}
    return table({rename.get(k, k): ds[k] for k in keys}, like=ds)


def nan_rows(ds: DataSet, keys: Optional[Sequence[str]] = None) -> np.ndarray:
    """Rows holding NaN in any of the float columns among `keys`."""
    bad = np.zeros(len(ds), bool)
    for k in ds.columns if keys is None else keys:
        v = ds[k]
        if v.dtype.kind == "f":
            bad |= np.isnan(v)
    return bad


def dropna(ds: DataSet, keys: Optional[Sequence[str]] = None) -> DataSet:
    """pandas' `dropna()` (or `dropna(subset=keys)`): the rows without a
    NaN, in order."""
    return ds.select(~nan_rows(ds, keys))


def stack_anomalous(ds: DataSet) -> DataSet:
    """Two-column (+/-) anomalous format -> one row per Friedel sign: the
    (+) rows, then the (-) rows with -HKL, each holding the value columns
    under their root names first and the other columns after, less the
    rows where any value column is NaN (careless_tpu/stats/_lib.py
    stack_anomalous)."""
    plus_cols = [c for c in ds.columns if c.endswith("(+)")]
    minus_cols = [c for c in ds.columns if c.endswith("(-)")]
    other = [c for c in ds.columns if c not in plus_cols + minus_cols]
    hkl = ds.get_hkls()
    roots = list(dict.fromkeys(c[:-3] for c in plus_cols + minus_cols))
    n = len(ds)

    def side(cols, sign):
        by_root = {c[:-3]: ds[c] for c in cols}
        out = {r: by_root.get(r, np.full(n, np.nan, np.float32))
               for r in roots}
        out.update((c, ds[c]) for c in other)
        out.update(H=sign * hkl[:, 0], K=sign * hkl[:, 1], L=sign * hkl[:, 2])
        return out

    plus, minus = side(plus_cols, 1), side(minus_cols, -1)
    out = DataSet({k: np.concatenate([plus[k], minus[k]]) for k in plus},
                  cell=ds.cell, spacegroup=ds.spacegroup)
    return dropna(out, sorted({c[:-3] for c in plus_cols}))


def read_careless_mtz(path: str) -> DataSet:
    """Read + normalize column aliases the way the stats CLIs expect: SIGI
    and SIGF renamed SigI and SigF, their MTZ types kept under the old
    names, as pandas' rename leaves the JAX DataSet's mtz_dtypes."""
    ds = read_mtz(path)
    return pick(ds, ds.columns, {"SIGI": "SigI", "SIGF": "SigF"})


def load_concat(paths: List[str], transform=None) -> DataSet:
    """Each file read, transformed, given dHKL, `file` (its path) and
    `Spacegroup`, and the rows of all in turn, with the first's context."""
    frames = []
    for m in paths:
        ds = read_careless_mtz(m)
        if transform is not None:
            ds = transform(ds)
        ds.compute_dHKL(inplace=True)
        ds["file"] = np.full(len(ds), m)
        ds["Spacegroup"] = np.full(len(ds), sg_name(ds))
        frames.append(ds)
    return concat_datasets(frames)


def inner_merge(left: DataSet, right: DataSet, on: Sequence[str],
                suffixes=("1", "2")) -> DataSet:
    """pandas' `merge(left, right, on=on, suffixes=suffixes)`: each left
    row in order joined to every right row of the same keys, in the right
    table's order; the key columns where the left table has them, the
    other left columns, then the right's, a shared name suffixed."""
    keys = np.concatenate([np.stack([left[k] for k in on], 1),
                           np.stack([right[k] for k in on], 1)]).astype(
        np.float64 if any(left[k].dtype.kind == "f" for k in on)
        else np.int64)
    _, ids = np.unique(keys, axis=0, return_inverse=True)
    ids = ids.reshape(-1)
    gl, gr = ids[:len(left)], ids[len(left):]
    order_r = np.argsort(gr, kind="stable")
    sorted_r = gr[order_r]
    lo = np.searchsorted(sorted_r, gl, side="left")
    counts = np.searchsorted(sorted_r, gl, side="right") - lo
    li = np.repeat(np.arange(len(left)), counts)
    offset = np.arange(len(li)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    ri = order_r[np.repeat(lo, counts) + offset]
    shared = set(left.columns) & set(right.columns) - set(on)
    cols = {}
    for k in left.columns:
        cols[k + suffixes[0] if k in shared else k] = left[k][li]
    for k in right.columns:
        if k not in on:
            cols[k + suffixes[1] if k in shared else k] = right[k][ri]
    return table(cols, like=left)


# ---------------------------------------------------------------- group-by
class GroupBy:
    """Rows of a table grouped by the values of key columns, in pandas'
    `groupby(keys)` order: groups sorted by their keys (numbers ascending,
    strings by code point), a group's rows in table order, rows with a NaN
    key dropped. `rows` lists the kept rows group after group; group g
    holds rows[starts[g]:starts[g] + counts[g]]."""

    def __init__(self, ds: DataSet, keys: Sequence[str]):
        self.keys = list(keys)
        rows = np.flatnonzero(~nan_rows(ds, self.keys))
        codes = [np.unique(ds[k][rows], return_inverse=True)[1].reshape(-1)
                 for k in self.keys]
        order = np.lexsort(codes[::-1])
        self.rows = rows[order]
        new = np.zeros(len(rows), bool)
        new[:1] = True
        for c in codes:
            c = c[order]
            new[1:] |= c[1:] != c[:-1]
        self.starts = np.flatnonzero(new)
        self.counts = np.diff(np.append(self.starts, len(rows)))
        self.group_of = np.repeat(np.arange(len(self.starts)), self.counts)
        self.key_values = {k: ds[k][self.rows[self.starts]] for k in self.keys}

    def __len__(self) -> int:
        return len(self.starts)

    def values(self, col: np.ndarray, dtype=None) -> np.ndarray:
        """The column's values in group order."""
        v = np.asarray(col)[self.rows]
        return v if dtype is None else v.astype(dtype)

    def segments(self):
        return ((s, s + c) for s, c in zip(self.starts, self.counts))

    def sum(self, v: np.ndarray) -> np.ndarray:
        """Per-group sums of values already in group order."""
        if not len(self):
            return np.zeros(0, v.dtype)
        return np.add.reduceat(v, self.starts)

    def min(self, col: np.ndarray) -> np.ndarray:
        if not len(self):
            return np.zeros(0, np.asarray(col).dtype)
        return np.minimum.reduceat(self.values(col), self.starts)

    def first(self, col: np.ndarray) -> np.ndarray:
        """pandas' `first()`: each group's first non-NaN value (NaN where a
        group holds none)."""
        v = self.values(col)
        if v.dtype.kind != "f" or not len(self):
            return v[self.starts]
        pos = np.where(np.isnan(v), len(v), np.arange(len(v)))
        first = np.minimum.reduceat(pos, self.starts)
        ends = self.starts + self.counts
        out = v[np.minimum(first, len(v) - 1)].copy()
        out[first >= ends] = np.nan
        return out

    def broadcast(self, per_group: np.ndarray, n: int, fill=0) -> np.ndarray:
        """A per-group value on each row of the table (pandas' transform);
        a dropped row gets `fill`."""
        out = np.full(n, fill, dtype=per_group.dtype)
        out[self.rows] = np.repeat(per_group, self.counts)
        return out


# ------------------------------------------------------------ correlations
def _degenerate(g: GroupBy, *cols) -> np.ndarray:
    """Groups of fewer than two rows, or where a column is constant."""
    bad = g.counts < 2
    for v in cols:   # values in group order
        bad |= (np.minimum.reduceat(v, g.starts)
                == np.maximum.reduceat(v, g.starts))
    return bad


def _pearson_sorted(g: GroupBy, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-group Pearson r of f64 values in group order (two passes)."""
    mx = g.sum(x) / g.counts
    my = g.sum(y) / g.counts
    dx = x - mx[g.group_of]
    dy = y - my[g.group_of]
    sxy, sxx, syy = g.sum(dx * dy), g.sum(dx * dx), g.sum(dy * dy)
    with np.errstate(divide="ignore", invalid="ignore"):
        return sxy / np.sqrt(sxx * syy)


def _ranks(g: GroupBy, v: np.ndarray) -> np.ndarray:
    """Average ranks from 1 within each group (scipy's rankdata 'average'),
    of values in group order."""
    order = np.lexsort((v, g.group_of))
    sv, sg = v[order], g.group_of[order]
    pos = np.arange(len(v)) - g.starts[sg] + 1.0
    new = np.ones(len(v), bool)
    new[1:] = (sv[1:] != sv[:-1]) | (sg[1:] != sg[:-1])
    run = np.cumsum(new) - 1
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(v)) - 1
    avg = (pos[first] + pos[last]) / 2.0
    out = np.empty(len(v))
    out[order] = avg[run]
    return out


def cc_funcs(key1: str, key2: str, sig1: Optional[str] = None,
             sig2: Optional[str] = None):
    """(pearson, spearman, weighted) CC functions of (table, GroupBy) ->
    one value per group: pandas' `DataFrame.corr` of the two columns in
    f64, the same of their average ranks, and weighted_pearsonr with
    w = 1 / (sig1^2 + sig2^2). A group of fewer than two rows or with a
    constant column gives NaN in each, as pandas' corr does (the JAX
    tool's weighted CC there is its rounding's noise)."""

    def xy(ds, g):
        return g.values(ds[key1], np.float64), g.values(ds[key2], np.float64)

    def pearson(ds, g):
        x, y = xy(ds, g)
        r = _pearson_sorted(g, x, y)
        r[_degenerate(g, x, y)] = np.nan
        return r

    def spearman(ds, g):
        x, y = xy(ds, g)
        r = _pearson_sorted(g, _ranks(g, x), _ranks(g, y))
        r[_degenerate(g, x, y)] = np.nan
        return r

    def weighted(ds, g):
        x, y = xy(ds, g)
        w = np.square(g.values(ds[sig1], np.float64))
        if sig2:
            w = w + np.square(g.values(ds[sig2], np.float64))
        w = np.reciprocal(w)
        sw = g.sum(w)
        mx = g.sum(w * x) / sw
        my = g.sum(w * y) / sw
        dx = x - mx[g.group_of]
        dy = y - my[g.group_of]
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = g.sum(w * dx * dy) / sw
            vx = g.sum(w * np.square(dx)) / sw
            vy = g.sum(w * np.square(dy)) / sw
            r = cov / np.sqrt(vx * vy)
        r[_degenerate(g, x, y)] = np.nan
        return r

    return {"pearson": pearson, "spearman": spearman, "weighted": weighted}


def grouped_result(ds: DataSet, g: GroupBy, name: str, values: np.ndarray,
                   labels: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """pandas' `apply(...).reset_index()` as columns: the group keys, the
    value column, and where `labels` are given the bin's "Resolution Range
    (Å)" and the group's first `Spacegroup`."""
    cols = dict(g.key_values)
    cols[name] = values
    if labels is not None:
        cols["Resolution Range (Å)"] = np.array(labels)[cols["bin"]]
        cols["Spacegroup"] = g.first(ds["Spacegroup"])
    return cols


# ------------------------------------------------------------------ output
def _cell(v) -> str:
    """A cell as to_csv writes it: the shortest repr, NaN as empty."""
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return ""
    return str(v)


def write_csv(result: DataSet, path: str) -> None:
    """pandas' `to_csv`: a leading unnamed index column, the header, one
    line a row, NaN as an empty cell."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + result.columns)
        cols = [result[k] for k in result.columns]
        for i in range(len(result)):
            w.writerow([str(i)] + [_cell(c[i]) for c in cols])


def to_text(result: DataSet) -> str:
    """A plain fixed-width table: the index and each column right-aligned."""
    cols = [[""] + [str(i) for i in range(len(result))]]
    for k in result.columns:
        cols.append([k] + [_cell(v) or "NaN" for v in result[k]])
    widths = [max(map(len, c)) for c in cols]
    return "\n".join("  ".join(c[i].rjust(w) for c, w in zip(cols, widths))
                     for i in range(len(cols[0])))


def emit(result: DataSet, args) -> None:
    if args.output is not None:
        write_csv(result, args.output)
    else:
        print(to_text(result))


def pyplot(args):
    """matplotlib's pyplot on the Agg backend unless --show; the
    ImportError, which names matplotlib, where it is not installed."""
    import matplotlib
    matplotlib.use("Agg" if not args.show else matplotlib.get_backend())
    import matplotlib.pyplot as plt
    return plt


LINESTYLES = ("-", "--", ":", "-.")


def levels(values: np.ndarray) -> list:
    """Hue or style levels as seaborn orders them: numbers sorted, strings
    in order of appearance."""
    values = np.asarray(values)
    if values.dtype.kind in "iuf":
        return list(np.unique(values))
    return list(dict.fromkeys(values.tolist()))


def draw_lines(ax, result: DataSet, x: str, y: str, hue=None, style=None,
               xpos=None):
    """seaborn's lineplot of a long table: one line per (hue, style) level,
    the mean of y over rows that share x, and the range of those rows
    shaded; black without a hue, Dark2 colours with one."""
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("Dark2")
    hues = levels(result[hue]) if hue else [None]
    styles = levels(result[style]) if style else [None]
    xs, ys = np.asarray(result[x]), np.asarray(result[y], np.float64)
    if xpos is not None:
        xs = np.asarray([xpos[v] for v in xs.tolist()])
    for i, h in enumerate(hues):
        for j, s in enumerate(styles):
            sel = np.ones(len(result), bool)
            if hue:
                sel &= np.asarray(result[hue]) == h
            if style:
                sel &= np.asarray(result[style]) == s
            if not sel.any():
                continue
            ux = np.unique(xs[sel])
            at = np.searchsorted(ux, xs[sel])
            cnt = np.bincount(at, minlength=len(ux))
            mean = np.bincount(at, ys[sel], minlength=len(ux)) / cnt
            lo = np.full(len(ux), np.inf)
            hi = np.full(len(ux), -np.inf)
            np.minimum.at(lo, at, ys[sel])
            np.maximum.at(hi, at, ys[sel])
            color = "k" if not hue else cmap(i % cmap.N)
            label = ", ".join(str(v) for v in (h, s) if v is not None) or None
            ax.plot(ux, mean, color=color, linestyle=LINESTYLES[
                j % len(LINESTYLES)], label=label)
            if (cnt > 1).any():
                ax.fill_between(ux, lo, hi, color=color, alpha=0.2, lw=0)
    if hue or style:
        ax.legend()


def lineplot(result, args, x, y, labels=None, bins=None, hue=None,
             style=None, ylabel=None, log=False):
    """careless_tpu/stats/_lib.py lineplot with matplotlib alone: the same
    axes, labels, ticks, ylim and log scale. Nothing is drawn, and
    matplotlib is not imported, unless -i or -s asks for a plot."""
    if args.image is None and not args.show:
        return
    plt = pyplot(args)
    plt.figure(figsize=(args.width, args.height))
    ax = plt.gca()
    draw_lines(ax, result, x, y, hue=hue, style=style)
    if log:
        ax.set(yscale="log")
    if labels is not None and bins is not None:
        plt.xticks(range(bins), labels, rotation=45, ha="right",
                   rotation_mode="anchor")
    if ylabel:
        plt.ylabel(ylabel)
    plt.xlabel("Resolution ($\\mathrm{\\AA}$)")
    plt.grid(which="both", axis="both", ls="dashdot")
    if args.ylim is not None:
        plt.ylim(args.ylim)
    plt.tight_layout()
    if args.image is not None:
        plt.savefig(args.image)
    if args.show:
        plt.show()
    plt.close("all")
