"""Share of the traced training steps in which the device ran no operation (%)."""

from harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
