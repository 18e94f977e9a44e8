"""Arithmetic of the program's spans inside the render (the port's
`utils/profiling.py`): the counted host reads, `sync.<reason>` spans, and the
device idle while the host is inside the `render` range.

Each returns None where the run has nothing to read: an untraced run, or a
trace without a `render` range.  A trace that holds a `render` range but no
`sync.*` span reads 0 syncs and 0 ms: a render that reads nothing back from
the device, or a program that does not count its reads (one without these
spans)."""

from __future__ import annotations

from .readers import per_unit_ms
from .trace import _union

RENDER = "render"
SYNC_PREFIX = "sync."


def _rendered(ctx):
    return ctx.trace is not None and ctx.trace.range_count(RENDER) > 0


def _sync_names(trace):
    return sorted(n for n in trace.host_names if n.startswith(SYNC_PREFIX))


def host_syncs(ctx):
    """`sync.*` spans per traced unit."""
    if not _rendered(ctx):
        return None
    tr = ctx.trace
    return sum(tr.range_count(n) for n in _sync_names(tr)) / tr.units


def sync_wait_ms(ctx):
    """Host time inside `sync.*` spans per traced unit (ms): the host's wait
    on the device at its deliberate reads."""
    if not _rendered(ctx):
        return None
    tr = ctx.trace
    return per_unit_ms(ctx, sum(tr.range_host_s(n) for n in _sync_names(tr)))


def render_idle_ms(ctx):
    """Device idle while the host is inside `render`, per traced unit (ms):
    the union of the `render` ranges' host intervals, clipped to the traced
    window, less the device busy time inside it."""
    if not _rendered(ctx):
        return None
    tr = ctx.trace
    spans = [[max(s, tr.t0), min(e, tr.t1)]
             for s, e in _union((r.time_range.start, r.time_range.end)
                                for r in tr._ranges(RENDER))
             if e > tr.t0 and s < tr.t1]
    inside_s = sum(e - s for s, e in spans) / 1e6
    return per_unit_ms(ctx, inside_s - tr.busy_within(spans))
