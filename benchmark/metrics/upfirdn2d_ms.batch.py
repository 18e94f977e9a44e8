"""Device time of the upfirdn2d kernel per traced batch (ms): every
operation whose name holds the kernel's name (`csrc/upfirdn2d.cu`, all its
paths), over the traced batches.  A program without the kernel (it ran the
FIR filters as cuDNN grouped convolutions) has nothing to read: None."""

from harness.readers import per_unit_ms

KERNEL = "upfirdn2d_polyphase"   # csrc/upfirdn2d.cu


def read(ctx):
    if ctx.trace is None:
        return None
    kernel_s = ctx.trace.kernel_s(KERNEL)
    if kernel_s <= 0:
        return None
    return per_unit_ms(ctx, kernel_s)
