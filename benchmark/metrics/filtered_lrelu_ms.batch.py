"""Device time of StyleGAN3's `filtered_lrelu` ranges per batch (ms): the
bias, both FIR filters and the leaky ReLU of every layer
(`ops/filtered_lrelu.py`)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "filtered_lrelu")
