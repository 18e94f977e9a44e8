"""Filtered leaky ReLU (NCHW), plain: the published composition
`_filtered_lrelu_ref` (NVlabs/stylegan3 `torch_utils/ops/filtered_lrelu.py`):

    1. add the bias,
    2. zero-insert upsample by `up`, pad, FIR-filter with `fu` at gain up^2,
    3. gain * leaky ReLU(slope), clamped to [-clamp, clamp],
    4. FIR-filter with `fd` and keep every `down`-th pixel,

each step one of this reference's `upfirdn2d` and `bias_act`.
"""

from __future__ import annotations

import math

from torch import nn

from .bias_act import bias_act
from .upfirdn2d import _parse_padding, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=math.sqrt(2), slope=0.2, clamp=None, flip_filter=False):
    """x `[N, C, H, W]`, b `[C]` or None; `fu`/`fd` f32 filters `[taps]`
    (separable) or `[fh, fw]`, or None.  `padding` is int, `[x, y]` or
    `[x0, x1, y0, y1]` on the upsampled image."""
    px0, px1, py0, py1 = _parse_padding(padding)
    x = bias_act(x, b, dim=1)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


class FilteredLrelu(nn.Module):
    """`filtered_lrelu` as a module without state, so that a count of
    operations can tell its FIR filters (grouped convolutions over
    zero-inserted images, which count the zeros) from the layer's own."""

    def forward(self, x, **kwargs):
        return filtered_lrelu(x, **kwargs)
