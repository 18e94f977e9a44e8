"""Bilinear 2D grid sampling, feature-last, port of
`pix2pix3d_tpu/ops/grid_sample.py` (the semantics of
`torch.nn.functional.grid_sample(..., mode='bilinear',
align_corners=False)` on `[N, H, W, C]` features).

`grid_sample_2d_patch` is what the importance renderer samples planes with:
the 2x2 corner patch at a base clamped to `[0, H-2] x [0, W-2]`, blended
with hat weights, which equals zeros padding for every point (texels that
the clamp shifts in get non-positive hat arguments).  The JAX package's
TPU gather-layout variants (`_rowpair`, `_blocked`, the packed block table)
compute the same function and are not ported: its renderer never selects
them.
"""

from __future__ import annotations

import torch


def _pixel_coords(coords, h, w):
    """Normalized (x, y) in [-1, 1] -> continuous pixel coords (ix, iy)
    with align_corners=False."""
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    return (x + 1.0) * (w * 0.5) - 0.5, (y + 1.0) * (h * 0.5) - 0.5


def _gather(flat, w, iy, ix):
    """flat [N, H*W, C] at integer (iy, ix) [N, M] -> [N, M, C]."""
    idx = (iy * w + ix)[..., None].expand(-1, -1, flat.shape[-1])
    return torch.gather(flat, 1, idx)


def grid_sample_2d_patch(features, coords):
    """features `[N, H, W, C]`, coords `[N, M, 2]` (x indexes W) ->
    `[N, M, C]` in features' dtype, zeros padding."""
    n, h, w, c = features.shape
    ix, iy = _pixel_coords(coords, h, w)
    iy0 = torch.floor(iy).clamp(0, h - 2)
    ix0 = torch.floor(ix).clamp(0, w - 2)

    wy0 = torch.clamp_min(1.0 - (iy - iy0).abs(), 0.0)
    wy1 = torch.clamp_min(1.0 - (iy - (iy0 + 1)).abs(), 0.0)
    wx0 = torch.clamp_min(1.0 - (ix - ix0).abs(), 0.0)
    wx1 = torch.clamp_min(1.0 - (ix - (ix0 + 1)).abs(), 0.0)

    flat = features.reshape(n, h * w, c)
    iy0, ix0 = iy0.long(), ix0.long()
    out = (_gather(flat, w, iy0, ix0).float() * (wy0 * wx0)[..., None]
           + _gather(flat, w, iy0, ix0 + 1).float() * (wy0 * wx1)[..., None]
           + _gather(flat, w, iy0 + 1, ix0).float() * (wy1 * wx0)[..., None]
           + _gather(flat, w, iy0 + 1, ix0 + 1).float() * (wy1 * wx1)[..., None])
    return out.to(features.dtype)


def grid_sample_2d(features, coords, padding_mode="zeros"):
    """features `[N, H, W, C]`, coords `[N, M, 2]` in [-1, 1] (x indexes W)
    -> `[N, M, C]`, padding 'zeros' or 'border'."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r} is not 'zeros'/'border'")
    n, h, w, c = features.shape
    ix, iy = _pixel_coords(coords, h, w)
    fx0 = torch.floor(ix)
    fy0 = torch.floor(iy)
    tx = ix - fx0
    ty = iy - fy0
    ix0, iy0 = fx0.long(), fy0.long()
    ix1, iy1 = ix0 + 1, iy0 + 1

    def valid(i, size):
        if padding_mode == "border":
            return torch.ones_like(tx)
        return ((i >= 0) & (i < size)).float()

    vx0, vx1, vy0, vy1 = valid(ix0, w), valid(ix1, w), valid(iy0, h), valid(iy1, h)
    ix0c, ix1c = ix0.clamp(0, w - 1), ix1.clamp(0, w - 1)
    iy0c, iy1c = iy0.clamp(0, h - 1), iy1.clamp(0, h - 1)

    flat = features.reshape(n, h * w, c)
    w00 = ((1 - tx) * (1 - ty) * vx0 * vy0)[..., None]
    w01 = (tx * (1 - ty) * vx1 * vy0)[..., None]
    w10 = ((1 - tx) * ty * vx0 * vy1)[..., None]
    w11 = (tx * ty * vx1 * vy1)[..., None]
    out = (_gather(flat, w, iy0c, ix0c) * w00 + _gather(flat, w, iy0c, ix1c) * w01
           + _gather(flat, w, iy1c, ix0c) * w10 + _gather(flat, w, iy1c, ix1c) * w11)
    return out.to(features.dtype)
