"""Device time inside the trainer's `phase_gmain` range per traced step (ms):
G's forward and backward through both discriminators, LPIPS and the
cross-view render."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "phase_gmain")
