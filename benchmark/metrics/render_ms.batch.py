"""Device time of the `render` range per batch (ms), with the fused
decode+composite kernel that the port launches through ctypes inside it
(the range's device-side spans hold it; harness/trace.py)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "render")
