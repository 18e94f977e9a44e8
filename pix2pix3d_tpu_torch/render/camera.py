"""Camera pose sampler and intrinsics helpers, port of
`pix2pix3d_tpu/render/camera.py` (ref `camera_utils.py`).

y-up look-at convention; poses are `[N, 4, 4]` cam2world, intrinsics
normalized by image size.
"""

from __future__ import annotations

import math

import torch

from .. import resolve_device
from .math_utils import normalize_vecs


def create_cam2world_matrix(forward_vector, origin):
    """Look-at cam2world, y-up, no roll (ref `camera_utils.py:118-137`)."""
    forward_vector = normalize_vecs(forward_vector)
    up_vector = torch.tensor([0.0, 1.0, 0.0], dtype=forward_vector.dtype,
                             device=forward_vector.device).expand_as(forward_vector)
    right_vector = -normalize_vecs(torch.linalg.cross(up_vector, forward_vector,
                                                      dim=-1))
    up_vector = normalize_vecs(torch.linalg.cross(forward_vector, right_vector,
                                                  dim=-1))
    rotation = torch.stack((right_vector, up_vector, forward_vector), dim=-1)
    n = forward_vector.shape[0]
    cam2world = torch.eye(4, dtype=forward_vector.dtype,
                          device=forward_vector.device).repeat(n, 1, 1)
    cam2world[:, :3, :3] = rotation
    cam2world[:, :3, 3] = origin
    return cam2world


def _origins_from_angles(h, v, radius):
    v = torch.clamp(v, 1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    x = radius * torch.sin(phi) * torch.cos(math.pi - h)
    z = radius * torch.sin(phi) * torch.sin(math.pi - h)
    y = radius * torch.cos(phi)
    return torch.cat([x, y, z], dim=-1)


class LookAtPoseSampler:
    """Pitch/yaw pose looking at a point (ref `camera_utils.py:58-85`).  Only
    the mean pose (the JAX package's `rng=None`) is ported: the serving
    path's cameras are given, not sampled.  `device` defaults to the card."""

    @staticmethod
    def sample(horizontal_mean, vertical_mean, lookat_position, radius=1.0,
               batch_size=1, device="cuda"):
        device = resolve_device(device)
        h =torch.full((batch_size, 1), float(horizontal_mean), device=device)
        v = torch.full((batch_size, 1), float(vertical_mean), device=device)
        origins = _origins_from_angles(h, v, radius)
        lookat = torch.as_tensor(lookat_position, dtype=torch.float32,
                                 device=device)
        return create_cam2world_matrix(normalize_vecs(lookat - origins), origins)


def fov_to_intrinsics(fov_degrees, device="cuda"):
    """Normalized 3x3 intrinsics from FOV in degrees (ref `camera_utils.py:140-154`)
    on `device` (default: the card)."""
    device = resolve_device(device)
    focal_length = 1 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414)
    return torch.tensor([[focal_length, 0, 0.5], [0, focal_length, 0.5],
                         [0, 0, 1]], dtype=torch.float32, device=device)


def pose_to_conditioning(cam2world, intrinsics):
    """Flatten pose to the 25-float conditioning vector."""
    n = cam2world.shape[0]
    return torch.cat([cam2world.reshape(n, 16),
                      intrinsics.reshape(-1, 9).expand(n, 9)], dim=1)
