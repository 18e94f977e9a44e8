"""Seeded inputs, made on the device: pools of label or edge maps, latents
and cameras on the orbit of the video app.

A traffic mix draws, for each unit of work, `batch` maps from a pool of
`pool` maps, a fresh z per image and a camera on the orbit (yaw pi/2 +
0.35 sin 2 pi t, pitch pi/2 - 0.05 + 0.25 cos 2 pi t), looking at the
configuration's pivot from its radius.  The orbit phases t are `phases`
evenly spaced points, (j + 0.5) / phases.  Every seed gives the same sizes
and the same set of maps' uses and phases in each run of `pool` and
`phases` images; the seed draws the maps, z, the weights and the order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def label_pool(gen, n, res, classes, device, blobs=16):
    """`[n, res, res, 1]` f32 label maps of smooth regions: the argmax over
    `classes` channels of low-resolution noise upsampled bilinearly."""
    noise = torch.randn((n, classes, blobs, blobs), generator=gen, device=device)
    up = F.interpolate(noise, size=(res, res), mode="bilinear", align_corners=False)
    return up.argmax(dim=1, keepdim=True).permute(0, 2, 3, 1).float()


def edge_pool(gen, n, res, device, blobs=8, regions=6):
    """`[n, res, res, 1]` f32 edge maps, 0 or 255: one-pixel lines on the
    borders between the smooth regions of a label map."""
    lab = label_pool(gen, n, res, regions, device, blobs)[..., 0]
    edge = torch.zeros_like(lab, dtype=torch.bool)
    edge[:, :, :-1] |= lab[:, :, :-1] != lab[:, :, 1:]
    edge[:, :-1, :] |= lab[:, :-1, :] != lab[:, 1:, :]
    return (edge.float() * 255.0)[..., None]


def mapping_input(maps, data_type):
    """The raw maps as the mapping takes them: labels as they are; edges
    (0..255) rescaled to [-1, 1] and inverted, as the apps feed them."""
    if data_type == "edge":
        return -(maps / 127.5 - 1)
    return maps


def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def orbit_cameras(t, radius, pivot, focal):
    """`[n, 25]` cameras (cam2world 4x4 and normalized intrinsics 3x3,
    flattened) at orbit phases t `[n]`: y-up look-at from `radius` about
    `pivot`."""
    yaw = math.pi / 2 + 0.35 * torch.sin(2 * math.pi * t)
    pitch = math.pi / 2 - 0.05 + 0.25 * torch.cos(2 * math.pi * t)
    v = pitch.clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    origin = torch.stack([radius * torch.sin(phi) * torch.cos(math.pi - yaw),
                          radius * torch.cos(phi),
                          radius * torch.sin(phi) * torch.sin(math.pi - yaw)], dim=-1)
    look = torch.tensor(pivot, dtype=torch.float32, device=t.device)
    forward = _normalize(look - origin)
    up = torch.tensor([0.0, 1.0, 0.0], device=t.device).expand_as(forward)
    right = -_normalize(torch.linalg.cross(up, forward, dim=-1))
    up = _normalize(torch.linalg.cross(forward, right, dim=-1))
    n = t.shape[0]
    c2w = torch.eye(4, device=t.device).repeat(n, 1, 1)
    c2w[:, :3, :3] = torch.stack((right, up, forward), dim=-1)
    c2w[:, :3, 3] = origin
    intr = torch.tensor([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]],
                        dtype=torch.float32, device=t.device)
    return torch.cat([c2w.reshape(n, 16), intr.reshape(1, 9).expand(n, 9)], dim=1)


class Requests:
    """The inputs of `units` units of `batch` images each, drawn from
    `seed` at once: `unit(k)` -> (z [B, z_dim], c [B, 25], mask [B, H, W, 1]),
    the mapping's input; units past `units` repeat from the start."""

    def __init__(self, seed, units, batch, camera, data, z_dim, device):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        res, pool = data["resolution"], data["pool"]
        if data["type"] == "seg":
            maps = label_pool(gen, pool, res, data["classes"], device)
        else:
            maps = edge_pool(gen, pool, res, device)
        self.maps = mapping_input(maps, data["type"])
        self.units, self.batch = units, batch
        n = torch.arange(units * batch, device=device)
        # every `pool` images in a row take each map once, and every `phases`
        # images each orbit phase once: a seed changes their order, not the set
        self.index = torch.randperm(pool, generator=gen, device=device)[n % pool] \
            .reshape(units, batch)
        self.z = torch.randn((units, batch, z_dim), generator=gen, device=device)
        phases = data["phases"]
        t = (torch.randperm(phases, generator=gen, device=device)[n % phases] + 0.5) / phases
        self.c = orbit_cameras(t, camera["radius"], camera["pivot"],
                               camera["focal"]).reshape(units, batch, 25)

    def unit(self, k):
        k = k % self.units
        return self.z[k], self.c[k], self.maps[self.index[k]]
