"""The result line: what a run prints last.

Metrics are read by the files under `metrics/`, one per metric, each a
function `read(ctx)` of the run's `Context`; a reader that finds nothing to
read returns None and the metric is left out of the line.
"""

from __future__ import annotations

import json
import sys

import torch

from . import spec


class Context:
    """What the readers see: `window` (harness/window.py), `trace`
    (harness/trace.py, traced runs), `setup_s`, `flops_per_unit` (traced
    runs), `unit_images` (images per unit), `peak_flops`, the cell's
    `traffic` and `config`, and for generator cells `gkw` and `nrr`, the
    generator's kwargs and render resolution as run."""

    def __init__(self, cell, measured, setup_s):
        self.cell = cell
        self.traffic = cell["traffic"]
        self.config = cell["config"]
        self.gkw = measured.get("gkw")      # the generator's kwargs as run
        self.nrr = measured.get("nrr")
        self.window = measured["window"]
        self.trace = measured.get("trace")
        self.flops_per_unit = measured.get("flops_per_unit")
        self.unit_images = measured["unit_images"]
        self.peak_flops = float(self.traffic["peak_flops"])
        self.setup_s = setup_s


def build(cell, measured, traced, device, setup_s):
    ctx = Context(cell, measured, setup_s)
    metrics = {}
    for m in cell["per_layer"] if traced else cell["end_to_end"]:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["workload"]["chips"],
           "memory_peak_bytes": int(measured.get("memory_peak_bytes", 0))}
    line = {"correct": None, "attempted": None, "failed": None,
            "metrics": metrics, "device": dev}
    if traced:
        tr = measured["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    worst = measured["compare"]
    line["correct"] = worst.correct
    line["attempted"] = ctx.window.units * ctx.unit_images
    line["failed"] = worst.failed
    line["checks"] = worst.checks()
    return line


def emit(line):
    """The checks as the last lines of standard error, then the line."""
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} against the limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
