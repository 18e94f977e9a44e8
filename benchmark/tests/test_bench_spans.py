"""The readers of the program's spans (`harness/spans.py`) on a made-up
trace in the style of test_bench_trace.py: host syncs and their waits per
unit, the device idle while the host is inside `render` (overlapping ranges,
ranges across the window's edges), None without a trace; then the readers
on a tiny CPU run of the port, whose frustum render records its spans."""

from types import SimpleNamespace as NS

import pytest
import torch

from harness import generate, result, spans, spec
from harness.trace import Trace
from test_bench_trace import ev
import tiny

SPAN_METRICS = ["host_syncs.batch", "host_syncs.serve", "sync_wait_ms.batch",
                "sync_wait_ms.serve", "render_idle_ms.batch", "render_idle_ms.serve",
                "render_prepare_host_ms.batch", "render_slabs_host_ms.batch"]


def ctx_of(events, units):
    return NS(trace=Trace(events, 1.0, units))


@pytest.fixture
def two_units():
    """Two units (0-100, 100-200 us).  Unit 1: `render` 10-60 holding
    `render.prepare` 10-20 and `render.slabs` 20-60 with two `sync.window`
    spans (30-35, 40-50).  Unit 2: `render` 110-150 with one `sync.window`
    (120-130) and one `sync.other` (135-137).  Device: busy 15-25, 45-55,
    80-90, 125-140."""
    s1, s2 = ev("sync.window", 30, 35), ev("sync.window", 40, 50)
    slabs = ev("render.slabs", 20, 60, children=[s1, s2])
    prep = ev("render.prepare", 10, 20)
    r1 = ev("render", 10, 60, children=[prep, slabs])
    u1 = ev("unit", 0, 100, children=[r1])
    s3, s4 = ev("sync.window", 120, 130), ev("sync.other", 135, 137)
    r2 = ev("render", 110, 150, children=[s3, s4])
    u2 = ev("unit", 100, 200, children=[r2])
    host = [u1, r1, prep, slabs, s1, s2, u2, r2, s3, s4]
    device = [ev("k", 15, 25, True), ev("k", 45, 55, True), ev("k", 80, 90, True),
              ev("k", 125, 140, True), ev("render", 15, 55, True)]
    return ctx_of(host + device, 2)


def test_syncs_and_their_waits_per_unit(two_units):
    assert spans.host_syncs(two_units) == pytest.approx(4 / 2)
    # waits 5 + 10 + 10 + 2 us over two units
    assert spans.sync_wait_ms(two_units) == pytest.approx(27e-6 / 2 * 1e3)


def test_render_idle_per_unit(two_units):
    # render 10-60: busy 15-25 and 45-55, idle 30; render 110-150: busy
    # 125-140, idle 25
    assert spans.render_idle_ms(two_units) == pytest.approx(55e-6 / 2 * 1e3)


def test_render_idle_is_part_of_the_idle(two_units):
    tr = two_units.trace
    idle_ms = (tr.window_s - tr.busy_s) / tr.units * 1e3
    assert 0 < spans.render_idle_ms(two_units) <= idle_ms


def test_render_idle_of_overlapping_ranges_across_the_window_edges():
    """Overlapping `render` ranges count once; a range that starts before the
    first unit or ends after the last counts only inside the window."""
    early = ev("render", -20, 30)              # before the window: 0-30 counts
    late = ev("render", 80, 130)               # after it: 80-100 counts
    inner = ev("render", 20, 40)               # overlaps `early`
    unit = ev("unit", 0, 100, children=[inner])
    device = [ev("k", -10, 5, True), ev("k", 35, 45, True), ev("k", 95, 120, True)]
    ctx = ctx_of([unit, early, late, inner] + device, 1)
    # host in render over 0-40 and 80-100 (60 us); busy inside: 0-5, 35-40,
    # 95-100 (15 us)
    assert spans.render_idle_ms(ctx) == pytest.approx(45e-3)
    tr = ctx.trace
    assert spans.render_idle_ms(ctx) <= (tr.window_s - tr.busy_s) * 1e3


def test_render_without_syncs_reads_zero():
    render = ev("render", 10, 60)
    ctx = ctx_of([ev("unit", 0, 100, children=[render]), render,
                  ev("k", 20, 30, True)], 1)
    assert spans.host_syncs(ctx) == 0
    assert spans.sync_wait_ms(ctx) == 0
    assert spans.render_idle_ms(ctx) == pytest.approx(40e-3)
    for name in ("render_prepare_host_ms.batch", "render_slabs_host_ms.batch"):
        assert spec.reader(name)(ctx) is None


def test_without_a_render_nothing_reads():
    sync = ev("sync.window", 10, 20)
    ctx = ctx_of([ev("unit", 0, 100, children=[sync]), sync], 1)
    assert spans.host_syncs(ctx) is None
    assert spans.sync_wait_ms(ctx) is None
    assert spans.render_idle_ms(ctx) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_reads_none_untraced_and_its_span_traced(name, two_units):
    read = spec.reader(name)
    assert read(NS(trace=None)) is None
    want = {"host_syncs": 2.0, "sync_wait_ms": 13.5e-3, "render_idle_ms": 27.5e-3,
            "render_prepare_host_ms": 5e-3, "render_slabs_host_ms": 20e-3}
    assert read(two_units) == pytest.approx(want[name.split(".")[0]])


def test_the_metrics_are_reported_where_listed():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    assert set(SPAN_METRICS) <= set(per_layer)
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["layer"] == "Render"
        serve = name.endswith(".serve")
        assert m["moves"] == ("serve_p95_ms" if serve else "images_per_s")
        cells = {"seg2cat-serve-b1"} if serve else {"seg2cat-batch32"}
        if name == "render_idle_ms.batch":
            cells.add("edge2car-batch32")
        assert set(m["workloads"]) == cells


def test_a_tiny_traced_run_of_the_port_reads_its_spans(monkeypatch):
    """The port's frustum render at the tiny size, with a contraction window
    narrower than the sheared texture, so each image, plane and chunk reads
    its window start once: 2 x 3 x 1 syncs a unit of 2 images."""
    cell = spec.cell("seg2cat-batch32")
    over = tiny.overrides("seg2cat-batch32")
    gen = dict(tiny.TINY_GENERATOR)
    gen["rendering_kwargs"] = dict(gen["rendering_kwargs"], frustum_window=(448, 448))
    over["config"]["paths"]["serving"]["generator"] = gen
    m = generate.measure(cell, 2**31 + 5, 0.5, True, torch.device("cpu"), over)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "stub")
    line = result.build(cell, m, True, torch.device("cpu"), 1.0)
    got = line["metrics"]
    assert got["host_syncs.batch"]["value"] == 6
    assert got["host_syncs.batch"]["unit"] == "syncs"
    for name in ("sync_wait_ms.batch", "render_idle_ms.batch",
                 "render_prepare_host_ms.batch", "render_slabs_host_ms.batch"):
        assert got[name]["value"] > 0, name
    slabs, waits = (got[n]["value"] for n in ("render_slabs_host_ms.batch",
                                               "sync_wait_ms.batch"))
    assert slabs >= waits
    assert not {n for n in SPAN_METRICS if n.endswith(".serve")} & set(got)
