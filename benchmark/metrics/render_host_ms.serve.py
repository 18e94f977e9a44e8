"""Host time of the `render` range per unit (ms): the frustum's or the
importance renderer's Python and launches, with its host syncs."""

from harness.readers import range_host_ms


def read(ctx):
    return range_host_ms(ctx, "render")
