"""Device time of the two super-resolution ranges, `sr_rgb` and
`sr_semantic`, per batch (ms)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "sr_rgb", "sr_semantic")
