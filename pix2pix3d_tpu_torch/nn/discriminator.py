"""Discriminator building blocks, port of `pix2pix3d_tpu/nn/discriminator.py`.

Only `DiscriminatorBlock` is ported so far, in the resnet architecture: the
mask encoder of the conditional mapping network is built from it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv2d


class DiscriminatorBlock(nn.Module):
    """Resnet downsampling block (ref `networks_stylegan2.py:559-643`)."""

    def __init__(self, in_channels, tmp_channels, out_channels, img_channels,
                 activation="lrelu", resample_filter=(1, 3, 3, 1), conv_clamp=None,
                 use_fp16=False):
        super().__init__()
        if in_channels not in (0, tmp_channels):
            raise ValueError("in_channels must be 0 or tmp_channels")
        self.in_channels = in_channels
        self.use_fp16 = use_fp16
        self.fromrgb = None
        if in_channels == 0:
            self.fromrgb = Conv2d(img_channels, tmp_channels, kernel_size=1,
                                  activation=activation, conv_clamp=conv_clamp)
        self.conv0 = Conv2d(tmp_channels, tmp_channels, kernel_size=3,
                            activation=activation, conv_clamp=conv_clamp)
        self.conv1 = Conv2d(tmp_channels, out_channels, kernel_size=3,
                            activation=activation, down=2,
                            resample_filter=resample_filter, conv_clamp=conv_clamp)
        self.skip = Conv2d(tmp_channels, out_channels, kernel_size=1, bias=False,
                           down=2, resample_filter=resample_filter)

    def forward(self, x, img, force_fp32=False):
        """x `[N, C, H, W]` or None (first block), img the input image;
        returns (x at half resolution, None)."""
        dtype = (torch.bfloat16 if (self.use_fp16 and not force_fp32)
                 else torch.float32)
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(dtype))
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x, None
