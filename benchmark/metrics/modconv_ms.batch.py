"""Device time of StyleGAN3's `modconv` ranges per batch (ms): every
layer's modulated convolution (`nn/stylegan3.py`)."""

from harness.readers import range_device_ms


def read(ctx):
    return range_device_ms(ctx, "modconv")
