"""Semantic mesh extraction, port of `pix2pix3d_tpu/apps/extract_mesh.py`
(ref `applications/extract_mesh.py`).

Dense sigma grid -> marching cubes (threshold 50, ref :192) -> semantic
vertex colors by re-sampling the field at the vertices (channels 32:32+S of
the decoder features, ref :207-216) -> .ply export.  The backbone runs ONCE
(the reference re-runs it for every 64³ block, `triplane_cond.py:1072`).

    python -m pix2pix3d_tpu_torch.apps.extract_mesh --network G.ckpt \\
        --cfg seg2cat --input mask.png --outdir out --resolution 256

`--device` (default `cuda`) picks the card or the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.triplane import _reshape_planes
from ..train.viz import color_mask
from ..utils.marching_cubes import marching_cubes
from .common import (build_app_generator, device_of, draw_z, inference,
                     mask_input)
from .generate_samples import frontal_pose, read_mask


def _padded_blocks(pts, block):
    """(start, n_valid, `[block, 3]` points) over `pts`, the last block
    padded with zeros."""
    for i in range(0, len(pts), block):
        chunk = pts[i:i + block]
        n_valid = len(chunk)
        if n_valid < block:
            chunk = torch.cat([chunk, chunk.new_zeros((block - n_valid, 3))])
        yield i, n_valid, chunk


def _field(G, planes, coords):
    """The decoder's outputs at `[M, 3]` points (zero directions)."""
    return G.run_model_planes(planes, coords[None], torch.zeros_like(coords)[None])


def sigma_field(G, ws, resolution=256, block=64 ** 3, box_side=None):
    """(Dense `[res, res, res]` sigma grid as numpy, planes); ref
    `get_sigma_field_np:60-81`.  The grid is evaluated in blocks of `block`
    points, the last one padded."""
    device = device_of(G)
    box_side = box_side or G.rendering_kwargs["box_warp"]
    half = box_side / 2
    g = np.linspace(-half, half, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = torch.from_numpy(pts).to(device)
    sigmas = torch.empty(len(pts), dtype=torch.float32, device=device)
    with inference():
        planes = _reshape_planes(G.backbone.synthesis(ws, noise_mode="const"))
        for i, n_valid, chunk in _padded_blocks(pts, block):
            sigmas[i:i + n_valid] = _field(G, planes, chunk)["sigma"][0, :n_valid, 0]
    return sigmas.reshape(resolution, resolution, resolution).cpu().numpy(), planes


def vertex_labels(G, planes, verts_w):
    """Semantic class of each `[V, 3]` world-space point: the argmax of the
    semantic logits (decoder channels 32:32+S) there, in padded blocks of
    65,536 points (ref extract_mesh.py:207-216)."""
    sem_ch = G.semantic_channels
    pts = torch.from_numpy(np.asarray(verts_w, np.float32)).to(device_of(G))
    labels = torch.empty(len(pts), dtype=torch.int64, device=pts.device)
    with inference():
        for i, n_valid, chunk in _padded_blocks(pts, 65536):
            sem = _field(G, planes, chunk)["rgb"][0, :n_valid, 32:32 + sem_ch]
            labels[i:i + n_valid] = sem.argmax(dim=-1)
    return labels.cpu().numpy()


def extract_semantic_mesh(G, ws, resolution=256, threshold=50.0):
    """Returns (verts in world coords, faces, vertex_colors uint8)."""
    box_side = G.rendering_kwargs["box_warp"]
    sigmas, planes = sigma_field(G, ws, resolution=resolution)
    verts, faces = marching_cubes(sigmas, threshold)
    # index coords -> world coords
    half = box_side / 2
    verts_w = verts / (resolution - 1) * box_side - half
    colors = np.zeros((len(verts_w), 3), np.uint8)
    if len(verts_w):
        colors = color_mask(vertex_labels(G, planes, verts_w)[None])[0]
    return verts_w, faces, colors


def save_ply(path, verts, faces, colors=None):
    """Minimal ASCII PLY writer (replaces the trimesh dependency)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--network", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--cfg", required=True,
                   choices=["seg2cat", "seg2face", "edge2car"])
    p.add_argument("--input", required=True)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--threshold", type=float, default=50.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    G, app = build_app_generator(args.cfg, checkpoint=args.network,
                                 device=args.device)
    device = device_of(G)
    mask = read_mask(args.input)
    pose = frontal_pose(args.cfg, app, device)[None]
    z = draw_z(G, args.random_seed, device)
    with inference():
        ws = G.mapping(z, pose, {"mask": mask_input(G, mask, device), "pose": pose})

    verts, faces, colors = extract_semantic_mesh(
        G, ws, resolution=args.resolution, threshold=args.threshold)
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, f"{args.cfg}_{args.random_seed}.ply")
    save_ply(out, verts, faces, colors)
    print(f"saved {len(verts)} verts / {len(faces)} faces to {out}")


if __name__ == "__main__":
    main()
