"""BENCHMARK.json against the benchmark contract's form, and the files the
harness finds by its names."""
import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return spec.manifest()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(m):
    assert set(m) == TOP
    assert 1 <= len(m["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(m, section):
    entries = m[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_configs(m):
    for c in m["configs"]:
        assert c["file"].startswith(m["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
        cfg = spec._json(spec.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] == "float32"


def test_cells(m):
    configs = {c["name"] for c in m["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])


def test_metrics(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for cell in (w["name"] for w in m["workloads"]):
        c = spec.cell(cell)
        names = {x["name"] for x in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in x.get("workloads", [w["name"] for w in m["workloads"]]):
            reported = {y["name"] for y in spec.cell(cell).end_to_end}
            assert x["moves"] in reported, (x["name"], cell)
        if x["unit"] == "%":
            assert x["name"].endswith("_roofline") or "mfu" in x["name"] \
                or "share" in x["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec.manifest()["workloads"]])
def test_discovery(cell):
    c = spec.cell(cell)
    assert c.traffic["observations"] > 0
    assert set(c.settings["limits"]) == {"loss_gap", "grad_gap",
                                         "change_gap"}
    for x in c.end_to_end + c.per_layer:
        assert callable(spec.reader(x["name"]))


def test_every_file_is_named_from_name_characters():
    for path in (spec.ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel
