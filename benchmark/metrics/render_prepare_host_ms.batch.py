"""Host time of the frustum render's `render.prepare` span per batch (ms): the
texture shears, one image and plane at a time."""

from harness.readers import range_host_ms


def read(ctx):
    return range_host_ms(ctx, "render.prepare")
