"""The result line of a run, driven through the whole harness at a tiny
size on the CPU (the card's name stubbed): exactly the keys the benchmark
prints, the metrics of the cell's kind, each compared number beside its
limit, last."""

import json

import pytest
import torch

from harness import generate, result, spec
import tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def measured():
    cell = spec.cell("edge2car-batch32")
    return cell, {traced: generate.measure(cell, 2**31 + 3, 0.5, traced, CPU,
                                           tiny.overrides("edge2car-batch32"))
                  for traced in (False, True)}


def line_of(cell, m, traced, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "stub")
    line = result.build(cell, m, traced, CPU, 12.5)
    result.emit(line)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    return line, err


def test_untraced_line(measured, monkeypatch, capsys):
    cell, ms = measured
    line, err = line_of(cell, ms[False], False, monkeypatch, capsys)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == ms[False]["window"].units * 2
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    checks = line["checks"]
    assert set(checks) == set(cell["limits"]["numbers"])
    tail = err.strip().splitlines()[-len(checks):]
    for name, text in zip(checks, tail):
        assert text.startswith(f"check {name}: ") and "limit" in text


def test_traced_line(measured, monkeypatch, capsys):
    cell, ms = measured
    line, _ = line_of(cell, ms[True], True, monkeypatch, capsys)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    names = {m["name"] for m in cell["per_layer"]}
    assert set(line["metrics"]) <= names
    # the CPU run has a traced window and a window, so these read
    assert {"idle_share.batch", "mfu.batch", "render_host_ms.batch"} <= set(line["metrics"])
