"""Finding a cell's pieces by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration, whose file the
manifest gives, and a traffic mix, read from traffic/<traffic>.json; its
own settings and the limits of its comparison are in
workloads/<cell>.json. The metrics it reports are the manifest's metrics
that list it under `workloads` or list no cells; each per-layer metric is
read by metrics/<name>.py.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    entry: dict       # its entry in the manifest's workloads
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    settings: dict    # workloads/<cell>.json
    end_to_end: list  # the manifest's metric entries it reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in m["configs"] if c["name"] == entry["config"])
    return Cell(name, entry, _json(ROOT / config["file"]),
                _json(HERE / "traffic" / f"{entry['traffic']}.json"),
                _json(HERE / "workloads" / f"{name}.json"),
                [x for x in m["end_to_end"] if _reports(x, name)],
                [x for x in m["per_layer"] if _reports(x, name)])


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
