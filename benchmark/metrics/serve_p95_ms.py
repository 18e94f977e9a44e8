"""The 95th percentile of every request latency in the window (ms), from
the call to the outputs on the device, synchronized."""


def read(ctx):
    return ctx.window.percentile_ms(95)
