"""Improved precision and recall, port of
`pix2pix3d_tpu/metrics/precision_recall.py` (ref
`metrics/precision_recall.py`, k-NN manifold estimate, k=3 for pr50k3).

The JAX package forms the `[1024, n, dim]` f64 differences in numpy (~33 GB
of host memory for pr2k, far more for pr50k3_full).  Here the pairwise
distances run on the features' device in f64, `torch.cdist` computing each
from the differences (not the |a|^2 + |b|^2 - 2ab expansion, whose
cancellation moves distances of near points), in blocks of `batch` query
rows (by default as many as keep a block's distances within
`BLOCK_BYTES`): the same radii to f64 rounding, so the same `<=` decisions
as numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import metric_utils

BLOCK_BYTES = 1 << 30


def _distance_blocks(query, support, batch=None):
    """(first row, `[rows, len(support)]` f64 distances) blocks of `batch`
    (default: sized to `BLOCK_BYTES`) of `query`'s rows against every row
    of `support`."""
    rows = batch or max(1, BLOCK_BYTES // (8 * support.shape[0]))
    for i in range(0, query.shape[0], rows):
        yield i, torch.cdist(query[i:i + rows], support,
                             compute_mode="donot_use_mm_for_euclid_dist")


def _knn_radii(feats, k, batch=None):
    """Distance of each row of `feats` (an f64 tensor) to its k-th nearest
    other row (the sorted distances' index k; index 0 is the row itself)."""
    radii = torch.empty(feats.shape[0], dtype=torch.float64, device=feats.device)
    for i, d in _distance_blocks(feats, feats, batch):
        radii[i:i + d.shape[0]] = d.kthvalue(k + 1, dim=1).values
    return radii


def _fraction_in_manifold(query, support, radii, batch=None):
    """Share of `query` rows within some support row's radius."""
    hits = 0
    for _, d in _distance_blocks(query, support, batch):
        hits += int((d <= radii[None]).any(dim=1).sum())
    return hits / query.shape[0]


def compute_pr(opts, max_real, num_gen, nhood_size=3):
    detector = metric_utils.get_feature_extractor(opts.device)
    real = metric_utils.iterate_real_features(opts, detector, max_items=max_real).get_all()
    gen = metric_utils.iterate_gen_features(opts, detector, max_items=num_gen).get_all()
    real = torch.from_numpy(real.astype(np.float64)).to(opts.device)
    gen = torch.from_numpy(gen.astype(np.float64)).to(opts.device)
    precision = _fraction_in_manifold(gen, real, _knn_radii(real, nhood_size))
    recall = _fraction_in_manifold(real, gen, _knn_radii(gen, nhood_size))
    return {"precision": precision, "recall": recall}
