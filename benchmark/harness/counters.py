"""Operation and byte counts, from shapes alone.

- `reference_flops`: the model's floating-point operations for one unit of
  work, counted by `torch.utils.flop_counter.FlopCounterMode` on the plain
  reference run on the `meta` device at the unit's shapes (products and
  convolutions; no device time, no data).  The texture resampling of the
  frustum render (its interpolation taps, written as products over the whole
  texture) is interpolation and not the model's work: the operations inside
  the reference's `resample` module are left out.
- `decode_composite_work`: bytes and operations of one call of the serving
  path's fused decode+composite kernel: each input byte read once and each
  output byte written once; the multiply-adds of the lateSeparate MLP's two
  products (W1 32x128; W2's two live blocks, 64x32 rgb and 64x33 semantic +
  sigma) for every sample.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

# the lateSeparate MLP's multiply-adds per sample (see the module docstring)
DECODE_MACS = 32 * 128 + 64 * 32 + 64 * 33


def reference_flops(reference, inputs, exclude=("resample",)):
    """Operations of `reference(*inputs)` (both on `meta`), without those
    inside submodules whose name is in `exclude`."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        reference(*inputs)
    counts = counter.get_flop_counts()
    total = sum(counter.flop_counts["Global"].values())
    skipped = 0
    for name, ops in counts.items():
        if name.split(".")[-1] in exclude:
            skipped += sum(ops.values())
    return total - skipped


def decode_composite_work(n, depth_steps, rays, feat_bytes):
    """(bytes, flops) of one fused decode+composite call over `n` images,
    `depth_steps` slabs and `rays` rays, with features of `feat_bytes`."""
    f32 = 4
    read = (depth_steps * n * 32 * rays * feat_bytes      # slab features
            + n * depth_steps * f32 + n * rays * f32       # depths, direction norms
            + (128 * 32 + 128 + 128 * 128 + 128) * f32)    # W1t, b1, W2t, b2
    written = n * (64 + 2) * rays * f32                    # colors, depth, weight sums
    flops = 2 * n * depth_steps * rays * DECODE_MACS
    return read + written, flops


def bound_s(n_bytes, flops, peak_flops):
    """The least time of the work on one H100: the larger of its bytes over
    the memory rate and its operations over the peak."""
    return max(n_bytes / HBM_BYTES_S, flops / peak_flops)
