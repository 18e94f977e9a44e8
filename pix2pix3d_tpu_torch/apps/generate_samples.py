"""Single-image inference app, port of `pix2pix3d_tpu/apps/generate_samples.py`
(ref `applications/generate_samples.py`).

Loads a checkpoint, conditions on a label/edge map (a PNG), renders color +
label outputs under a frontal pose (or `--pose`).

    python -m pix2pix3d_tpu_torch.apps.generate_samples --network G.ckpt \\
        --cfg seg2cat --input mask.png --outdir out --random_seed 1 7

`--device` (default `cuda`) picks the card or, with `--device cpu`, the CPU.
z is drawn from `torch.Generator().manual_seed(seed)`, so a `--random_seed`
gives another z than the JAX app gives for it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train.viz import color_mask
from .common import (as_f32, build_app_generator, device_of, draw_z,
                     inference, intrinsics_for, mask_input, to_numpy, to_uint8)


def generate_sample(G, app, mask, pose, z=None, seed=0, truncation_psi=1.0):
    """mask `[H, W, 1]` raw (seg labels / edge uint8), pose `[25]`; z `[1,
    z_dim]` (drawn from `seed` if None).  Returns the generator's outputs,
    NHWC, on G's device."""
    device = device_of(G)
    if z is None:
        z = draw_z(G, seed, device)
    expected = G.backbone.mapping.in_resolution
    if mask.shape[0] != expected or mask.shape[1] != expected:
        raise ValueError(
            f"input mask is {mask.shape[0]}x{mask.shape[1]} but this model "
            f"expects {expected}x{expected}; resize the label map first")
    z = as_f32(z, device)
    pose = as_f32(pose, device)[None]
    batch = {"mask": mask_input(G, mask, device), "pose": pose}
    with inference():
        ws = G.mapping(z, pose, batch, truncation_psi=truncation_psi)
        return G.synthesis(ws, pose,
                           neural_rendering_resolution=app["neural_rendering_resolution"],
                           noise_mode="const", det=True)


def save_outputs(out, outdir, prefix, data_type, semantic_channels):
    import PIL.Image

    os.makedirs(outdir, exist_ok=True)
    color = to_uint8(out["image"][0])
    PIL.Image.fromarray(color).save(os.path.join(outdir, f"{prefix}_color.png"))
    sem = to_numpy(out["semantic"][0])
    if data_type == "seg":
        label = np.argmax(sem, axis=-1)
        PIL.Image.fromarray(color_mask(label[None])[0]).save(
            os.path.join(outdir, f"{prefix}_label.png"))
    else:
        edge = np.clip((1 - sem[..., 0]) * 127.5 + 127.5, 0, 255).astype(np.uint8)
        PIL.Image.fromarray(edge).save(os.path.join(outdir, f"{prefix}_label.png"))


def read_mask(path):
    """A label/edge PNG as `[H, W, 1]` (the first channel of a color PNG)."""
    import PIL.Image

    mask = np.array(PIL.Image.open(path))
    if mask.ndim == 3:
        mask = mask[..., 0]
    return mask[:, :, None]


def frontal_pose(cfg_name, app, device):
    """The apps' default camera: frontal, radius 1.7 for edge2car, else 2.7."""
    from ..render.camera import LookAtPoseSampler, pose_to_conditioning
    radius = 1.7 if cfg_name == "edge2car" else 2.7
    c2w = LookAtPoseSampler.sample(np.pi / 2, np.pi / 2, [0, 0, 0],
                                   radius=radius, batch_size=1, device=device)
    return pose_to_conditioning(c2w, intrinsics_for(app, device))[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--network", required=True, help=".pkl or .ckpt checkpoint")
    p.add_argument("--outdir", required=True)
    p.add_argument("--cfg", required=True,
                   choices=["seg2cat", "seg2face", "edge2car"])
    p.add_argument("--input", required=True, help="input label/edge PNG")
    p.add_argument("--pose", default=None,
                   help=".npy 25-float pose; default frontal")
    p.add_argument("--random_seed", type=int, nargs="+", default=[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    G, app = build_app_generator(args.cfg, checkpoint=args.network,
                                 device=args.device)
    mask = read_mask(args.input)
    if args.pose:
        pose = np.load(args.pose)
    else:
        pose = frontal_pose(args.cfg, app, args.device)

    for seed in args.random_seed:
        out = generate_sample(G, app, mask, pose, seed=seed)
        save_outputs(out, args.outdir, f"{args.cfg}_{seed}", G.data_type,
                     G.semantic_channels)
        print(f"saved {args.cfg}_{seed} to {args.outdir}")


if __name__ == "__main__":
    main()
