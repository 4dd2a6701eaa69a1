"""BENCHMARK.json against the contract's shape, its names and units, and
every file a cell or a metric is found by."""

import copy
import json

import pytest

from portbench import spec

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def bench():
    return spec.load()


def test_top_level_and_entry_keys():
    b = bench()
    assert set(b) == TOP
    for group, keys in KEYS.items():
        for entry in b[group]:
            optional = ({"workloads"} if group in ("end_to_end", "per_layer")
                        else set())
            extra = set(entry) - keys - optional
            assert keys <= set(entry) and not extra, (group, entry["name"])


def test_names_and_units_pass_the_check():
    assert spec.check_names(bench()) == []


@pytest.mark.parametrize("field,value", [
    ("name", "has space"), ("name", "a,b"), ("name", "a/b"), ("name", ".dot"),
    ("name", "µs"), ("name", "x" * 65), ("unit", "tokens per second"),
    ("unit", "x" * 17), ("unit", "µs")])
def test_the_check_refuses_bad_names_and_units(field, value):
    b = copy.deepcopy(bench())
    target = b["per_layer"][0]
    target[field] = value
    assert spec.check_names(b)


def test_the_check_refuses_a_name_twice():
    b = copy.deepcopy(bench())
    b["workloads"].append(dict(b["workloads"][0]))
    assert spec.check_names(b)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_every_cells_files_load_by_name(cell):
    b = bench()
    w = spec.cell(b, cell)
    conf = spec.read_json("configs", w["config"])
    traffic = spec.read_json("traffic", w["traffic"])
    limits = spec.read_json("limits", w["name"])
    assert hasattr(spec.driver(traffic["kind"]), "run")
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert conf["reduced"] == next(c["reduced"] for c in b["configs"]
                                   if c["name"] == w["config"])
    assert w["chips"] in (1, 4)
    reported = spec.metrics_of(b, "end_to_end", cell)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert spec.metrics_of(b, "per_layer", cell)


@pytest.mark.parametrize("metric",
                         [m["name"] for m in spec.load()["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    b = bench()
    m = next(x for x in b["per_layer"] if x["name"] == metric)
    assert callable(spec.metric_reader(metric).read)
    assert spec.metric_reader(metric).read({}) is None
    moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_configuration_files_are_their_own():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["source"] == c["source"]


def test_bounds_and_run_seconds_within_the_contract():
    b = bench()
    assert 1 <= b["run_seconds"] <= 51
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
