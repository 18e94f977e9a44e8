"""Two-pass importance-sampled tri-plane volume renderer, port of
`pix2pix3d_tpu/render/renderer.py` (ref
`training/volumetric_rendering/renderer.py:82-253`).

The generator's default sampler.  A coarse stratified pass, an inverse-CDF
resample of the coarse weights, a fine pass, and a composite over the merged
samples.  As in the JAX package the merge never builds merged color
tensors: depths and densities are sorted together, the compositing weights
are computed on the sorted scalars, and each original sample's midpoint
coefficient is scattered back to its place, so
`sum_i w_i (c_i + c_{i+1}) / 2` over the merged order becomes
`sum_j coeff_j c_j` over the original samples.

Randomness comes from one explicit `torch.Generator` (JAX: an rng key).
The two frameworks draw different numbers from a seed, so only `det=True`
renders compare with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample_2d_patch
from . import math_utils
from .ray_marcher import (compute_weights_3d, finalize_composite_3d,
                          march_rays_3d, midpoint_coefficients)


def generate_plane_axes():
    """Axis matrices of the 3 canonical planes (ref `renderer.py:23-37`)."""
    return np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                     [[0, 0, 1], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)


_INV_PLANE_AXES = np.linalg.inv(generate_plane_axes())  # [3, 3, 3]


def _uniform(generator, shape, device):
    """U[0, 1) draws from `generator` (on its own device), on `device`."""
    if generator is None:
        raise ValueError("det=False draws random numbers: pass a torch.Generator")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def project_onto_planes(coordinates):
    """[N, M, 3] world coords -> [N, 3, M, 2] per-plane 2D coords
    (ref `renderer.py:39-53`).  The inverse plane axes are permutations, so
    the product is taken elementwise: exact in f32 whatever the TF32
    setting (the JAX package pins Precision.HIGHEST here)."""
    inv = torch.from_numpy(_INV_PLANE_AXES).to(coordinates.device,
                                              coordinates.dtype)
    proj = (coordinates[:, None, :, :, None] * inv[None, :, None, :, :]).sum(dim=3)
    return proj[..., :2]


def sample_from_planes(plane_features, coordinates, box_warp):
    """Bilinear samples of the 3 planes `[N, 3, H, W, C]` at 3D points
    `[N, M, 3]` -> `[N, 3, M, C]` (ref `renderer.py:55-65`)."""
    n, n_planes, h, w, c = plane_features.shape
    m = coordinates.shape[1]
    proj = project_onto_planes((2 / box_warp) * coordinates)
    out = grid_sample_2d_patch(plane_features.reshape(n * n_planes, h, w, c),
                               proj.reshape(n * n_planes, m, 2).float())
    return out.reshape(n, n_planes, m, c)


def make_plane_sampler(plane_features, box_warp):
    """`coords [N, M, 3] -> features [N, 3, M, C]` over one plane set (the
    JAX package's live branch: the patch sampler)."""
    planes = plane_features.contiguous()
    return lambda coords: sample_from_planes(planes, coords, box_warp)


def _smooth_weights(weights):
    """max-pool(2, 1, pad 1) then avg-pool(2, 1) along the sample axis
    (ref `renderer.py:204-207`): `[NR, L]` -> `[NR, L]`."""
    wp = F.pad(weights, (1, 1), value=float("-inf"))
    mx = torch.maximum(wp[:, :-1], wp[:, 1:])
    return (mx[:, :-1] + mx[:, 1:]) / 2


def sample_pdf(generator, bins, weights, n_importance, det=False, eps=1e-5):
    """Inverse-CDF sampling (ref `renderer.py:214-253`).  bins `[NR, B]`,
    weights `[NR, B-2]` (reference quirk: the last bin is never indexed)."""
    nr, n_weights = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)],
                    dim=-1)                                   # [NR, W+1]
    if det:
        u = torch.linspace(0.0, 1.0, n_importance,
                           device=bins.device).expand(nr, n_importance)
    else:
        u = _uniform(generator, (nr, n_importance), bins.device)
    # the JAX package's comparison count sum(cdf <= u) is searchsorted(right)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, n_weights)
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins, 1, below)
    bins_g1 = torch.gather(bins, 1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, 1.0, denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def render_rays(run_model_fn, ray_origins, ray_directions, rendering_options,
                generator=None, det=False):
    """Two-pass hierarchical render over a field.

    run_model_fn(coords `[N, M, 3]`, dirs `[N, M, 3]`) ->
        {'rgb': `[N, M, C]`, 'sigma': `[N, M, 1]`}.
    Returns (features `[N, R, C]`, depth `[N, R, 1]`, weight_sum `[N, R, 1]`).
    """
    opts = rendering_options
    if opts["ray_start"] == opts["ray_end"] == "auto":
        ray_start, ray_end = math_utils.get_ray_limits_box(
            ray_origins, ray_directions, box_side_length=opts["box_warp"])
        is_valid = ray_end > ray_start
        # invalid rays take the min/max valid start over the whole batch
        start_min = torch.where(is_valid, ray_start, float("inf")).min()
        start_max = torch.where(is_valid, ray_start, float("-inf")).max()
        ray_start = torch.where(is_valid, ray_start, start_min)[..., 0]
        ray_end = torch.where(is_valid, ray_end, start_max)[..., 0]
    else:
        ray_start, ray_end = opts["ray_start"], opts["ray_end"]

    depths_coarse = ImportanceRenderer.sample_stratified(
        generator, ray_origins, ray_start, ray_end, opts["depth_resolution"],
        opts.get("disparity_space_sampling", False), det=det)
    n, r, s_coarse = depths_coarse.shape

    def eval_at(depths, s):
        # depth-major point order, as the JAX package: consecutive points
        # are adjacent rays at one depth
        coords = (ray_origins[:, :, None, :]
                  + depths[..., None] * ray_directions[:, :, None, :])
        coords = coords.transpose(1, 2).reshape(n, s * r, 3)
        dirs = ray_directions[:, None].expand(n, s, r, 3).reshape(n, s * r, 3)
        out = run_model_fn(coords, dirs)
        colors = out["rgb"].reshape(n, s, r, -1).transpose(1, 2)
        densities = out["sigma"].reshape(n, s, r).transpose(1, 2)
        return colors, densities

    colors_coarse, densities_coarse = eval_at(depths_coarse, s_coarse)

    n_imp = opts["depth_resolution_importance"]
    if n_imp <= 0:
        rgb, depth, weights = march_rays_3d(colors_coarse, densities_coarse,
                                            depths_coarse, opts)
        return rgb, depth[..., None], weights.sum(dim=-1)[..., None]

    weights = compute_weights_3d(densities_coarse, depths_coarse, opts)
    depths_fine = ImportanceRenderer.sample_importance(
        generator, depths_coarse, weights, n_imp, det=det)
    colors_fine, densities_fine = eval_at(depths_fine, n_imp)

    # merged composite without merged colors: a stable sort keeps coarse
    # samples ahead of fine ones at equal depth, as lax.sort does
    all_depths = torch.cat([depths_coarse, depths_fine], dim=-1)
    all_densities = torch.cat([densities_coarse, densities_fine], dim=-1)
    d_sorted, perm = torch.sort(all_depths, dim=-1, stable=True)
    sig_sorted = torch.gather(all_densities, -1, perm)
    w_merged = compute_weights_3d(sig_sorted, d_sorted, opts)
    coeff_merged = midpoint_coefficients(w_merged)            # sorted order
    coeff = torch.empty_like(coeff_merged).scatter_(-1, perm, coeff_merged)

    rgb = (torch.einsum("nrs,nrsc->nrc", coeff[..., :s_coarse], colors_coarse)
           + torch.einsum("nrs,nrsc->nrc", coeff[..., s_coarse:], colors_fine))
    weight_total = w_merged.sum(dim=-1)
    depth = (coeff * all_depths).sum(dim=-1) / weight_total
    rgb, depth = finalize_composite_3d(rgb, depth, weight_total, all_depths, opts)
    return rgb, depth[..., None], weight_total[..., None]


class ImportanceRenderer:
    """Coarse stratified pass -> importance resample -> merged fine pass
    (ref `renderer.py:82-253`).  The decoder is a callable
    `decoder(sampled_features [N, 3, M, C], directions [N, M, 3]) ->
    {'rgb': [N, M, K], 'sigma': [N, M, 1]}`."""

    def __call__(self, planes, decoder, ray_origins, ray_directions,
                 rendering_options, generator=None, det=False):
        def run(coords, dirs):
            return self.run_model(planes, decoder, coords, dirs,
                                  rendering_options, generator=generator)
        return render_rays(run, ray_origins, ray_directions, rendering_options,
                           generator=generator, det=det)

    def run_model(self, planes, decoder, sample_coordinates, sample_directions,
                  options, generator=None):
        """Tri-plane sample + decoder at `[N, M, 3]` points, in chunks of
        `options['point_chunk']` (default 65536) points per image."""
        chunk = int(options.get("point_chunk", 65536))
        m = sample_coordinates.shape[1]
        if options.get("plane_dtype") == "bfloat16":
            planes = planes.to(torch.bfloat16)
        sampler = make_plane_sampler(planes, options["box_warp"])

        def eval_points(coords, dirs):
            return decoder(sampler(coords).float(), dirs)

        if m <= chunk:
            out = eval_points(sample_coordinates, sample_directions)
        else:
            parts = [eval_points(sample_coordinates[:, i:i + chunk],
                                 sample_directions[:, i:i + chunk])
                     for i in range(0, m, chunk)]
            out = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

        if options.get("density_noise", 0) > 0:
            if generator is None:
                raise ValueError("density_noise draws random numbers: pass a "
                                 "torch.Generator")
            noise = torch.randn(out["sigma"].shape, generator=generator,
                                device=generator.device)
            out["sigma"] = out["sigma"] + noise.to(out["sigma"].device) \
                * options["density_noise"]
        return out

    @staticmethod
    def sample_stratified(generator, ray_origins, ray_start, ray_end,
                          depth_resolution, disparity_space_sampling=False,
                          det=False):
        """Jittered uniform depths `[N, R, S]` (ref `renderer.py:169-192`)."""
        n, m, _ = ray_origins.shape
        dev = ray_origins.device
        if disparity_space_sampling:
            depths = torch.linspace(0.0, 1.0, depth_resolution, device=dev) \
                .reshape(1, 1, -1).expand(n, m, depth_resolution)
            delta = 1 / (depth_resolution - 1)
            if not det:
                depths = depths + _uniform(generator, depths.shape, dev) * delta
            return 1.0 / (1.0 / ray_start * (1.0 - depths) + 1.0 / ray_end * depths)

        if isinstance(ray_start, torch.Tensor) and ray_start.ndim > 0:
            # per-ray bounds from the auto box intersection, [N, M]
            steps = torch.linspace(0.0, 1.0, depth_resolution, device=dev)
            depths = ray_start[..., None] + steps * (ray_end - ray_start)[..., None]
            delta = (ray_end - ray_start)[..., None] / (depth_resolution - 1)
        else:
            depths = torch.linspace(float(ray_start), float(ray_end),
                                    depth_resolution, device=dev) \
                .reshape(1, 1, -1).expand(n, m, depth_resolution)
            delta = (ray_end - ray_start) / (depth_resolution - 1)
        if not det:
            depths = depths + _uniform(generator, depths.shape, dev) * delta
        return depths

    @staticmethod
    def sample_importance(generator, z_vals, weights, n_importance, det=False):
        """PDF-resampled depths `[N, R, S_imp]` (ref `renderer.py:194-212`);
        z_vals `[N, R, S]`, weights `[N, R, S-1]`."""
        n, r, s = z_vals.shape
        z_flat = z_vals.detach().reshape(n * r, s)
        w_flat = _smooth_weights(weights.detach().reshape(n * r, -1)) + 0.01
        z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
        samples = sample_pdf(generator, z_mid, w_flat[:, 1:-1], n_importance,
                             det=det)
        return samples.reshape(n, r, n_importance)

    @staticmethod
    def unify_samples(depths1, colors1, densities1, depths2, colors2, densities2):
        """Reference-style merge into sorted tensors (`renderer.py:157-167`);
        `render_rays` composites without building these."""
        all_depths = torch.cat([depths1, depths2], dim=-2)
        all_colors = torch.cat([colors1, colors2], dim=-2)
        all_densities = torch.cat([densities1, densities2], dim=-2)
        indices = torch.argsort(all_depths, dim=-2, stable=True)
        packed = torch.cat([all_depths, all_colors, all_densities], dim=-1)
        packed = torch.gather(packed, -2, indices.expand_as(packed))
        c = all_colors.shape[-1]
        return packed[..., :1], packed[..., 1:1 + c], packed[..., 1 + c:]
