"""The fused decode+composite kernel's share of its roofline (%): the
least time of its work on the inputs a batch gives it (bytes over the
memory rate or operations over the bf16 peak, harness/counters.py) over its
device time, per batch."""

from harness.readers import decode_composite_roofline_pct


def read(ctx):
    return decode_composite_roofline_pct(ctx)
