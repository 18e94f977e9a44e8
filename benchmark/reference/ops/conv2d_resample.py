"""2D convolution with optional FIR up/downsampling (NCHW).

Port of `pix2pix3d_tpu/ops/conv2d_resample.py`: every case is an upfirdn2d
stage around one plain convolution.  Weights are OIHW
`[out_ch, in_ch // groups, kh, kw]`.  `padding` is given w.r.t. the
*upsampled* image and includes the conv kernel's halo.

`flip_weight=True` is correlation (the PyTorch/XLA default); the reference
uses `flip_weight=False` (true convolution) for its upsampling layers.
"""

from __future__ import annotations

import torch.nn.functional as F

from . import conv2d_gradfix
from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d


def _conv2d(x, w, stride=1, padding=(0, 0, 0, 0), groups=1, flip_weight=True):
    """Plain conv; `padding` is (px0, px1, py0, py1) and may be negative."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    if any(padding):
        x = F.pad(x, list(padding))
    return conv2d_gradfix.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """Conv with optional up/downsampling; x `[N, C_in, H, W]`,
    w `[C_out, C_in // groups, kh, kw]`."""
    up, down = int(up), int(down)
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # Fold the FIR halo into the padding (ref conv2d_resample.py:85-96).
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1 and down > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)
    return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups,
                   flip_weight=flip_weight)
