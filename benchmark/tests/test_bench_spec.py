"""BENCHMARK.json and the files it names: every cell's pieces are found by
name, and the entries keep the benchmark's rules (names, units, which cells
report which metric)."""

import json
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert json.load(open(spec.ROOT / c["file"]))["name"] == c["name"]


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_are_found_by_name(name):
    cell = spec.cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert cell["traffic"]["kind"] in ("generate",)
    assert set(cell["limits"]["numbers"]) and all(
        v >= 0 for v in cell["limits"]["numbers"].values())
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_it_must(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer and "\n" not in layer for layer in layers)
    assert {m["layer"] for m in BENCH["per_layer"] if m["name"].startswith("idle_share")} \
        == {"Device"}


def test_every_metric_has_a_reader():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (spec.BENCH / "metrics").glob("*.py")}
    assert names <= files
