"""Inception Score, port of `pix2pix3d_tpu/metrics/inception_score.py` (ref
`metrics/inception_score.py`, `is50k`).

Needs classifier logits, i.e. converted Inception weights
(`PIX2PIX3D_INCEPTION_NPZ`); raises the JAX package's RuntimeError for the
random-convolution proxy, which has none.
"""

from __future__ import annotations

import numpy as np
import torch

from . import metric_utils


@torch.no_grad()
def compute_is(opts, num_gen, num_splits=10):
    detector = metric_utils.get_feature_extractor(opts.device)
    if not hasattr(detector, "logits"):
        raise RuntimeError(
            "Inception Score needs classifier logits; set "
            "PIX2PIX3D_INCEPTION_NPZ to converted Inception-v3 weights "
            "(scripts/convert_inception.py).")

    # the generation loop of iterate_gen_features, collecting logits
    rng, generator = metric_utils.seeded(opts)
    probs = []
    done = 0
    batch_size = 8
    while done < num_gen:
        z, mask, pose = metric_utils.sample_inputs(opts, rng, generator, batch_size)
        out = opts.G(z, pose, {"mask": mask, "pose": pose},
                     noise_mode="const", det=True)
        logit = detector.logits(metric_utils.generated_images(out))
        e = np.exp(logit - logit.max(axis=1, keepdims=True))
        probs.append(e / e.sum(axis=1, keepdims=True))
        done += batch_size
    probs = np.concatenate(probs)[:num_gen]

    scores = []
    for part in np.array_split(probs, num_splits):
        kl = part * (np.log(part + 1e-12)
                     - np.log(part.mean(axis=0, keepdims=True) + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))
