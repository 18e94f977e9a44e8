"""Ray/box geometry helpers, port of `pix2pix3d_tpu/render/math_utils.py`
(ref `training/volumetric_rendering/math_utils.py`)."""

from __future__ import annotations

import torch


def normalize_vecs(vectors):
    return vectors / torch.linalg.norm(vectors, dim=-1, keepdim=True)


def get_ray_limits_box(rays_o, rays_d, box_side_length):
    """Intersect rays with the centered cube of side `box_side_length`.

    Returns (t_min `[..., 1]`, t_max `[..., 1]`); invalid rays get
    (-1, -2) like the reference (`math_utils.py:46-98`)."""
    shape = rays_o.shape
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)

    half = box_side_length / 2
    invdir = 1 / rays_d
    # for each axis: entry at the near face, exit at the far face
    t0 = (-half - rays_o) * invdir
    t1 = (half - rays_o) * invdir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    is_valid = tmin <= tmax

    tmin = torch.where(is_valid, tmin, -1.0)
    tmax = torch.where(is_valid, tmax, -2.0)
    return tmin.reshape(*shape[:-1], 1), tmax.reshape(*shape[:-1], 1)


def linspace_batched(start, stop, num):
    """[num, *start.shape] linspace inclusive (ref `math_utils.py:103-120`)."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape((-1,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
