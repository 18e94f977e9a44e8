"""Device time of the generator's `backbone` range per batch (ms)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "backbone")
