"""Pad / upsample / FIR-filter / downsample for batches of 2D images (NCHW).

Port of `pix2pix3d_tpu/ops/upfirdn2d.py`.  The behavioural spec is the
reference's pure implementation (`torch_utils/ops/upfirdn2d.py:_upfirdn2d_ref`):

    1. zero-insert upsample by `up` (each pixel followed by up-1 zeros),
    2. pad with `padding` (negative = crop),
    3. correlate with the (optionally flipped) FIR filter, valid windows only,
    4. keep every `down`-th pixel.

Filters are float32 `[fh, fw]` (non-separable) or `[taps]` (separable).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import conv2d_gradfix


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _get_filter_size(f):
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None,
                 device="cpu"):
    """Prepare a FIR filter (ref `upfirdn2d.setup_filter`): accepts
    `[fh, fw]`, `[taps]`, scalar or None; normalizes to unit DC gain;
    separable representation for 1D filters with >= 8 taps."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.as_tensor(np.ascontiguousarray(f), dtype=torch.float32,
                           device=device)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR filter and downsample a batch of NCHW images.

    `padding` is int, `[x, y]` or `[x0, x1, y0, y1]`, relative to the
    upsampled image; negative values crop."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got {tuple(x.shape)}")
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    n, c, h, w = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)

    # 1. zero-insert upsample
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    # 2. pad / crop (F.pad crops on negative pads)
    x = F.pad(x, [px0, px1, py0, py1])
    # 3. correlate with the flipped filter
    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        x = conv2d_gradfix.conv2d(x, f[None, None].repeat(c, 1, 1, 1), groups=c)
    else:
        x = conv2d_gradfix.conv2d(x, f[None, None, None, :].repeat(c, 1, 1, 1),
                                  groups=c)
        x = conv2d_gradfix.conv2d(x, f[None, None, :, None].repeat(c, 1, 1, 1),
                                  groups=c)
    # 4. decimate
    if downx > 1 or downy > 1:
        x = x[:, :, ::downy, ::downx]
    return x


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Filter NCHW images, output shape matches input."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample NCHW images with FIR smoothing."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)



def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample NCHW images with FIR anti-aliasing (ref `upfirdn2d.py:354-389`)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
