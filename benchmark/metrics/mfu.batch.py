"""Model operations (the reference's, counted on meta) per second of the
window, as a share of the traffic's peak (%)."""

from harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
