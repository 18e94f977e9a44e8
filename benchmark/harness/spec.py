"""Find a cell's pieces by name.

`BENCHMARK.json` names each cell's configuration and traffic mix and each
metric; the files live under `benchmark/`:

- `configs/<config>.json`: the model as it is run (the file named in the
  configuration's entry);
- `traffic/<traffic>.json`: the traffic mix's parameters;
- `limits/<cell>.json`: the correctness limits of the cell, each with the
  readings it was set from;
- `metrics/<metric>.py`: the reader of one per-layer metric, a function
  `read(ctx)` that returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name, spec=None):
    """{name, workload, config, traffic, limits, end_to_end, per_layer} of
    the cell `name` (KeyError if BENCHMARK.json has no such cell)."""
    spec = spec or benchmark()
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    return {
        "name": name,
        "workload": work,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if _applies(m, name)],
    }


def reader(metric_name):
    """The `read` function of `metrics/<metric_name>.py`."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
