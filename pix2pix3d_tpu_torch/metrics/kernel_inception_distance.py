"""KID, port of `pix2pix3d_tpu/metrics/kernel_inception_distance.py` (ref
`metrics/kernel_inception_distance.py`): polynomial-kernel MMD over feature
subsets, in numpy, with the JAX package's `RandomState(seed)` subset draws."""

from __future__ import annotations

import numpy as np

from . import metric_utils


def kid_from_features(real, gen, num_subsets=100, max_subset_size=1000, seed=0):
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen[rng.choice(gen.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ y.T / n + 1) ** 3
        b = (x @ x.T / n + 1) ** 3
        c = (y @ y.T / n + 1) ** 3
        t += (b.sum() - np.trace(b)) / (m - 1) \
            + (c.sum() - np.trace(c)) / (m - 1) \
            - 2 * a.sum() / m
    return float(t / num_subsets / m)


def compute_kid(opts, max_real, num_gen):
    detector = metric_utils.get_feature_extractor(opts.device)
    real = metric_utils.iterate_real_features(opts, detector, max_items=max_real).get_all()
    gen = metric_utils.iterate_gen_features(opts, detector, max_items=num_gen).get_all()
    return kid_from_features(real, gen)
