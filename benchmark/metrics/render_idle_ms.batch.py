"""Device idle while the host is inside the `render` range, per batch (ms):
the part of the device's idle time that the render's host work leaves."""

from harness.spans import render_idle_ms


def read(ctx):
    return render_idle_ms(ctx)
