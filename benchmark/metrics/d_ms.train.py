"""Device time inside the discriminators' phases (`phase_dmain`,
`phase_dreg`, `phase_dsmain`, `phase_dsreg`) per traced step (ms)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "phase_dmain", "phase_dreg", "phase_dsmain", "phase_dsreg")
