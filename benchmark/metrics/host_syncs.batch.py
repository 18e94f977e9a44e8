"""Host syncs per batch: the program's `sync.*` spans
(`utils/profiling.host_read`; the frustum render's window starts), 0 where
the render ran without one."""

from harness.spans import host_syncs


def read(ctx):
    return host_syncs(ctx)
