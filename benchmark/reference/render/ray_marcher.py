"""Volume-rendering quadrature, port of `pix2pix3d_tpu/render/ray_marcher.py`
(ref `training/volumetric_rendering/ray_marcher.py:20-63`: MipNeRF-style
midpoint rule with softplus(x-1) density).

The `*_3d` functions carry depths/densities as `[N, R, S]`, sample axis
last, as the JAX package does; `march_rays` keeps the reference's
`[..., S, 1]` interface.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.bias_act import softplus


def compute_weights_3d(densities, depths, rendering_options):
    """Compositing weights `[N, R, S-1]` of sorted samples
    (densities/depths `[N, R, S]`)."""
    if rendering_options["clamp_mode"] != "softplus":
        raise ValueError("only clamp_mode='softplus' is supported (as the "
                         "reference)")
    deltas = depths[..., 1:] - depths[..., :-1]
    # activation bias of -1 makes things initialize better (ref :33)
    densities_mid = softplus((densities[..., :-1] + densities[..., 1:]) / 2 - 1)
    alpha = 1 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                               1 - alpha + 1e-10], dim=-1)
    transmittance = torch.cumprod(alpha_shifted, dim=-1)[..., :-1]
    return alpha * transmittance


def midpoint_coefficients(weights):
    """coeff_k = (w_{k-1} + w_k) / 2 (w out of range = 0), so that
    sum_i w_i (x_i + x_{i+1}) / 2 == sum_k coeff_k x_k.
    weights `[N, R, S-1]` -> `[N, R, S]`."""
    wp = F.pad(weights, (1, 1))
    return (wp[..., :-1] + wp[..., 1:]) / 2


def finalize_composite_3d(composite_rgb, composite_depth, weight_total, depths,
                          rendering_options):
    """Depth NaN handling and clamp to the range of ALL depths, white_back,
    output scaling (ref :46-55)."""
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())
    if rendering_options.get("white_back", False):
        composite_rgb = composite_rgb + (1 - weight_total)[..., None]
    return composite_rgb * 2 - 1, composite_depth


def march_rays_3d(colors, densities, depths, rendering_options):
    """Composite sorted samples: colors `[N, R, S, C]`, densities/depths
    `[N, R, S]` -> (rgb `[N, R, C]`, depth `[N, R]`, weights `[N, R, S-1]`)."""
    weights = compute_weights_3d(densities, depths, rendering_options)
    coeff = midpoint_coefficients(weights)
    composite_rgb = torch.einsum("nrs,nrsc->nrc", coeff, colors)
    weight_total = weights.sum(dim=-1)
    composite_depth = (coeff * depths).sum(dim=-1) / weight_total
    composite_rgb, composite_depth = finalize_composite_3d(
        composite_rgb, composite_depth, weight_total, depths, rendering_options)
    return composite_rgb, composite_depth, weights


def march_rays(colors, densities, depths, rendering_options):
    """Reference interface: densities/depths `[N, R, S, 1]` -> (rgb
    `[N, R, C]`, depth `[N, R, 1]`, weights `[N, R, S-1, 1]`)."""
    rgb, depth, weights = march_rays_3d(colors, densities[..., 0],
                                        depths[..., 0], rendering_options)
    return rgb, depth[..., None], weights[..., None]
