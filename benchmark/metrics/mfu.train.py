"""The reference step's operations, weighted to one average window step, at
the H100's peaks (the program's bf16 blocks at the bf16 dense peak, the
rest at the FP32 peak) over the window's time per step (%): the least time
of the step's work over its time."""

from harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
