"""The program's counted host reads (`sync.*` spans of
`utils/profiling.host_read`, the step's stats among them) per traced step;
None in a run without a trace or without a `phase_gmain` range."""

SYNC_PREFIX = "sync."


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.range_count("phase_gmain"):
        return None
    names = [n for n in tr.host_names if n.startswith(SYNC_PREFIX)]
    return sum(tr.range_count(n) for n in names) / tr.units
