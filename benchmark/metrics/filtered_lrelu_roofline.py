"""StyleGAN3's filtered leaky ReLU's share of its roofline (%): the least
time of a batch's calls over the device time in the `filtered_lrelu` ranges
a batch.

The least time is the larger of the calls' bytes at 3.35 TB/s and their
polyphase operations at the bf16 dense peak (harness/counters.py
`bound_s`), the work of harness/filtered_lrelu_work.py, which any
implementation of the op reads alike.  A run without the ranges (an
untraced run, a program without the span) has nothing to read: None."""

from harness import counters, filtered_lrelu_work

RANGE = "filtered_lrelu"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.range_device_s(RANGE)
    if device_s <= 0:
        return None
    n_bytes, flops = filtered_lrelu_work.cell_work(ctx.gkw, ctx.traffic["batch"])
    bound = counters.bound_s(n_bytes, flops, counters.PEAK_FLOPS["bf16"])
    return 100.0 * bound * ctx.trace.units / device_s
