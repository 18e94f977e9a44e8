"""Bilinear image resize (NCHW), port of `pix2pix3d_tpu/ops/resize.py`.

`F.interpolate(mode="bilinear", align_corners=False)` uses the same
half-pixel sample positions as `jax.image.resize(method="linear")`; with
`antialias=True` both widen the triangle kernel by the scale factor when
downsampling.  On the SR path the resize is an upsample (128 -> 512 for the
8XDC stacks), where antialias has no effect; tests/test_torch_ops.py holds
it against the JAX function at those sizes.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size, antialias=True):
    """Resize `[N, C, H, W]` to spatial `size` (int or (h, w))."""
    if isinstance(size, int):
        size = (size, size)
    if tuple(x.shape[2:]) == tuple(size):
        return x
    out = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.to(x.dtype)
