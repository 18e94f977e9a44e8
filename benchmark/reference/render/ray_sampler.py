"""Camera rays from cam2world + intrinsics, port of
`pix2pix3d_tpu/render/ray_sampler.py` (ref `volumetric_rendering/ray_sampler.py`)."""

from __future__ import annotations

import torch


def sample_rays(cam2world_matrix, intrinsics, resolution):
    """Per-pixel ray origins and normalized world directions, each
    `[N, resolution**2, 3]` (pixel centers, row-major)."""
    n = cam2world_matrix.shape[0]
    m = resolution ** 2
    dev = cam2world_matrix.device
    cam_locs_world = cam2world_matrix[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    coords = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) \
        / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam = xx.reshape(1, m).expand(n, m)
    y_cam = yy.reshape(1, m).expand(n, m)
    z_cam = torch.ones((n, m), dtype=torch.float32, device=dev)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel_points = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)],
                                 dim=-1)                        # [N, M, 4]
    world_points = torch.einsum("nij,nmj->nmi", cam2world_matrix,
                                cam_rel_points)[:, :, :3]
    ray_dirs = world_points - cam_locs_world[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=2, keepdim=True)
    ray_origins = cam_locs_world[:, None, :].expand_as(ray_dirs)
    return ray_origins, ray_dirs
