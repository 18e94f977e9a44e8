"""Host time of the frustum render's `render.slabs` spans per batch (ms): the
slab resamples of every chunk, image and plane, with their window-start
syncs."""

from harness.readers import range_host_ms


def read(ctx):
    return range_host_ms(ctx, "render.slabs")
