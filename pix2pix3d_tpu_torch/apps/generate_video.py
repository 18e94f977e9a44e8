"""Camera-orbit video app, port of `pix2pix3d_tpu/apps/generate_video.py`
(ref `applications/generate_video.py`).

One mapping pass, then `n_frames` synthesis passes under a LookAt orbit
(yaw +-0.35, pitch +-0.25 sinusoid, ref `generate_video.py:54-69`).  The
tri-plane backbone runs ONCE; every frame renders from the cached planes
(`G.synthesis(planes=...)`).

    python -m pix2pix3d_tpu_torch.apps.generate_video --network G.ckpt \\
        --cfg seg2cat --input mask.png --outdir out --frames 120

`--device` (default `cuda`) picks the card or the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.triplane import _reshape_planes
from ..render.camera import LookAtPoseSampler, pose_to_conditioning
from ..train.viz import color_mask
from .common import (as_f32, build_app_generator, device_of, draw_z,
                     inference, intrinsics_for, mask_input, to_numpy, to_uint8)
from .generate_samples import read_mask


def orbit_poses(app, n_frames=120, yaw_range=0.35, pitch_range=0.25,
                radius=2.7, pivot=(0, 0, 0), device="cuda"):
    """`[n_frames, 25]` poses of the orbit, on `device`."""
    intr = intrinsics_for(app, device)
    poses = []
    for i in range(n_frames):
        t = i / n_frames
        yaw = np.pi / 2 + yaw_range * np.sin(2 * np.pi * t)
        pitch = np.pi / 2 - 0.05 + pitch_range * np.cos(2 * np.pi * t)
        c2w = LookAtPoseSampler.sample(yaw, pitch, list(pivot), radius=radius,
                                       batch_size=1, device=device)
        poses.append(pose_to_conditioning(c2w, intr)[0])
    return torch.stack(poses)


def render_video(G, app, mask, cond_pose, z=None, seed=0, n_frames=120,
                 radius=2.7, pivot=(0, 0, 0)):
    """(frames uint8 `[H, W, 3]`, colorized label frames for seg models).
    z `[1, z_dim]` is drawn from `seed` if None."""
    device = device_of(G)
    if z is None:
        z = draw_z(G, seed, device)
    z = as_f32(z, device)
    cond_pose = as_f32(cond_pose, device)[None]
    batch = {"mask": mask_input(G, mask, device), "pose": cond_pose}
    nrr = app["neural_rendering_resolution"]
    poses = orbit_poses(app, n_frames=n_frames, radius=radius, pivot=pivot,
                        device=device)
    frames, labels = [], []
    with inference():
        ws = G.mapping(z, cond_pose, batch)
        # cache the planes: the backbone once, synthesis per frame on them
        planes = _reshape_planes(G.backbone.synthesis(ws, noise_mode="const"))
        for pose in poses:
            out = G.synthesis(ws, pose[None], neural_rendering_resolution=nrr,
                              noise_mode="const", det=True, planes=planes)
            frames.append(to_uint8(out["image"][0]))
            if G.data_type == "seg":
                sem = to_numpy(out["semantic"][0])
                labels.append(color_mask(np.argmax(sem, -1)[None])[0])
    return frames, labels


def save_gif(frames, path, fps=60):
    import PIL.Image

    imgs = [PIL.Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 10), loop=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--network", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--cfg", required=True,
                   choices=["seg2cat", "seg2face", "edge2car"])
    p.add_argument("--input", required=True)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    G, app = build_app_generator(args.cfg, checkpoint=args.network,
                                 device=args.device)
    mask = read_mask(args.input)
    radius = 1.7 if args.cfg == "edge2car" else 2.7
    pivot = (0, 0, -0.06) if args.cfg == "seg2cat" else (0, 0, 0)
    cond_pose = orbit_poses(app, 1, 0, 0, radius=radius, pivot=pivot,
                            device=args.device)[0]

    frames, labels = render_video(G, app, mask, cond_pose,
                                  seed=args.random_seed, n_frames=args.frames,
                                  radius=radius, pivot=pivot)
    os.makedirs(args.outdir, exist_ok=True)
    save_gif(frames, os.path.join(args.outdir,
                                  f"{args.cfg}_{args.random_seed}_color.gif"))
    if labels:
        save_gif(labels, os.path.join(args.outdir,
                                      f"{args.cfg}_{args.random_seed}_label.gif"))
    print(f"saved {len(frames)} frames to {args.outdir}")


if __name__ == "__main__":
    main()
