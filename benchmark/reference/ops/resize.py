"""Bilinear image resize (NCHW), port of `pix2pix3d_tpu/ops/resize.py`.

The function of `F.interpolate(mode="bilinear", align_corners=False)` and
of `jax.image.resize(method="linear")`: half-pixel sample positions, and
with `antialias=True` a triangle kernel widened by the scale factor when
downsampling.  It is computed as `jax.image.resize` computes it, as two
products with per-axis weight matrices (`_weights`, the formula of JAX's
`compute_weight_mat`), so its gradients are products too: `F.interpolate`'s
backward on the card adds with atomics, and a training step through it
would not repeat bit for bit.  f32 products follow the precision policy
(`ops/precision.py`).  tests/test_torch_ops.py holds it against the JAX
function and against `F.interpolate` and its gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _weights(n_in, n_out, antialias, device):
    """`[n_in, n_out]` f32 weights: output sample j is column j's sum of
    inputs (JAX's `compute_weight_mat` at translation 0, in f64)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def resize_bilinear(x, size, antialias=True):
    """Resize `[N, C, H, W]` to spatial `size` (int or (h, w))."""
    if isinstance(size, int):
        size = (size, size)
    h, w = x.shape[2:]
    if (h, w) == tuple(size):
        return x
    wy = _weights(h, size[0], antialias, x.device)
    wx = _weights(w, size[1], antialias, x.device)
    out = torch.matmul(wy.t(), torch.matmul(x.float(), wx))
    return out.to(x.dtype)
