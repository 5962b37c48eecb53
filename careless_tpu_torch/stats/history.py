"""Plot the per-step training metrics written by a careless-tpu run.

The port's careless_tpu/stats/history.py: read a `*_history.csv`, draw
every metric column against the step on a log-scale y axis, pair each
`<name>_val` column with its training counterpart (same Dark2 colour,
dashed line, "Test" in the legend), add a dashed grid, and save to `-o`
and/or show with `--show`. The CSV is read with the csv module (a column
without a name is "Unnamed: <i>", numbers as floats), the plot drawn with
matplotlib alone.
"""
import csv
from argparse import ArgumentParser as _AP, RawTextHelpFormatter

import numpy as np


class ArgumentParser(_AP):
    def __init__(self, *args, **kwargs):
        super().__init__(formatter_class=RawTextHelpFormatter,
                         description=__doc__)
        self.add_argument("history_csv", type=str,
                          help="A _history.csv file generated by careless-tpu")
        self.add_argument("-o", type=str, default=None,
                          help="Output image file name")
        self.add_argument("-s", "--show", action="store_true")


VAL_SUFFIX = "_val"


def read_history(history_csv) -> dict:
    """The CSV's columns by name, each a float64 array (an empty cell NaN)."""
    with open(history_csv, newline="") as f:
        rows = list(csv.reader(f))
    header = [h or f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    body = [r for r in rows[1:] if r]
    return {h: np.array([float(r[i]) if r[i] != "" else np.nan
                         for r in body]) for i, h in enumerate(header)}


def plot_history(history_csv, step_key="step"):
    import matplotlib.pyplot as plt

    table = read_history(history_csv)
    n = len(next(iter(table.values()), []))
    steps = table[step_key] if step_key in table else range(n)
    base_names = []
    for c in table:
        if c == step_key:
            continue
        base = c.removesuffix(VAL_SUFFIX)
        if base not in base_names:
            base_names.append(base)

    cmap = plt.get_cmap("Dark2")
    ax = plt.gca()
    for i, name in enumerate(base_names):
        color = cmap(i % cmap.N)
        if name in table:
            ax.plot(steps, table[name], color=color, label=f"{name} (Train)")
        val_col = name + VAL_SUFFIX
        if val_col in table:
            ax.plot(steps, table[val_col], color=color, linestyle="--",
                    label=f"{name} (Test)")
    ax.set_xlabel(step_key)
    ax.set_ylabel("value")
    ax.set_yscale("log")
    ax.grid(which="both", axis="both", linestyle="--")
    ax.legend()


def run_analysis(parser):
    import matplotlib
    matplotlib.use("Agg" if not parser.show else matplotlib.get_backend())
    import matplotlib.pyplot as plt
    plot_history(parser.history_csv)
    if parser.o is not None:
        plt.savefig(parser.o, dpi=300)
    if parser.show:
        plt.show()
    plt.close("all")


def main(argv=None):
    run_analysis(ArgumentParser().parse_args(argv))


if __name__ == "__main__":
    main()
