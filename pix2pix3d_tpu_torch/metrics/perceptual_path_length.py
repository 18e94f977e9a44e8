"""Perceptual path length, port of
`pix2pix3d_tpu/metrics/perceptual_path_length.py` (ref
`metrics/perceptual_path_length.py`, `ppl2_wend`: W space, endpoint
sampling, epsilon 1e-4).

The distance is the port's LPIPS (`train/lpips.py`: converted VGG weights
if given, else its seeded random VGG).  Products and convolutions run with
TF32 off: a step of 1e-4 in W moves the images far less than TF32's
rounding.  A generator with bf16 blocks (the serving configuration) rounds
much of that step away as well; its PPL measures that rounding more than
the path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import precision
from ..train.lpips import LPIPS
from . import metric_utils


@torch.no_grad()
@precision.policy(False)
def compute_ppl(opts, num_samples=2000, epsilon=1e-4, batch_size=4,
                lpips_weights=None):
    G = opts.G
    lp = LPIPS(weights_path=lpips_weights).to(opts.device)
    rng, generator = metric_utils.seeded(opts)

    dists = []
    done = 0
    while done < num_samples:
        z0, mask, pose = metric_utils.sample_inputs(opts, rng, generator, batch_size)
        z1 = metric_utils.draw_normal(generator, tuple(z0.shape)).to(opts.device)
        batch = {"mask": mask, "pose": pose}

        # endpoint interpolation in W (lerp; 'wend' sampling)
        w0 = G.mapping(z0, pose, batch)
        w1 = G.mapping(z1, pose, batch)
        t = metric_utils.draw_uniform(generator, (batch_size, 1, 1)).to(opts.device)
        wt0 = w0 + (w1 - w0) * t
        wt1 = w0 + (w1 - w0) * (t + epsilon)

        img0 = G.synthesis(wt0, pose, noise_mode="const", det=True)["image"]
        img1 = G.synthesis(wt1, pose, noise_mode="const", det=True)["image"]
        d = lp(img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)) / (epsilon ** 2)
        dists.append(d.cpu().numpy())
        done += batch_size

    dists = np.concatenate(dists)
    # ref filters outliers to the [1%, 99%] range before averaging
    lo, hi = np.percentile(dists, [1, 99])
    return float(dists[(dists >= lo) & (dists <= hi)].mean())
