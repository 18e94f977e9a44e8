"""Filtered leaky ReLU (NCHW), port of `pix2pix3d_tpu/ops/filtered_lrelu.py`:
bias, up-FIR, gain * leaky ReLU + clamp, down-FIR.

The behavioural spec is the reference's composition `_filtered_lrelu_ref`
(`torch_utils/ops/filtered_lrelu.py:124-158`), which the JAX package
composes from its `upfirdn2d` and `bias_act` as this module composes it from
the port's.  Only StyleGAN3's `SynthesisLayerS3` uses it.  Each call runs
inside a `filtered_lrelu` span (`utils/profiling.annotate`) and adds one to
`filtered_lrelu.calls`.
"""

from __future__ import annotations

import math

from ..utils.profiling import annotate
from .bias_act import bias_act
from .upfirdn2d import _parse_padding, upfirdn2d


class _FilteredLrelu:
    """Callable op (the module's `filtered_lrelu`); `calls` counts calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                 gain=math.sqrt(2), slope=0.2, clamp=None, flip_filter=False):
        """x `[N, C, H, W]`, b `[C]` or None; `fu`/`fd` f32 filters `[taps]`
        (separable) or `[fh, fw]`, or None.  `padding` is int, `[x, y]` or
        `[x0, x1, y0, y1]` on the upsampled image."""
        self.calls += 1
        with annotate("filtered_lrelu"):
            px0, px1, py0, py1 = _parse_padding(padding)
            x = bias_act(x, b, dim=1)
            x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                          flip_filter=flip_filter)
            x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
            return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


filtered_lrelu = _FilteredLrelu()
