"""FID, port of `pix2pix3d_tpu/metrics/frechet_inception_distance.py` (ref
`metrics/frechet_inception_distance.py:22-43`); the math in numpy.

FD = |mu_1 - mu_2|^2 + Tr(C_1 + C_2 - 2 sqrt(C_1 C_2)); the matrix square
root through eigendecompositions of symmetric matrices (no scipy).
`compute_fid` takes the features of the dataset's images and of the
generator's samples from `metric_utils.get_feature_extractor` (Inception-v3
with `PIX2PIX3D_INCEPTION_NPZ`, else the random-convolution proxy).
"""

from __future__ import annotations

import numpy as np

from . import metric_utils


def _sqrtm_product_trace(c1, c2):
    """Tr(sqrt(C1 C2)) for PSD C1, C2 via the symmetric reformulation
    Tr(sqrt(C1 C2)) = Tr(sqrt(S C2 S)) with S = sqrt(C1)."""
    w1, v1 = np.linalg.eigh(c1)
    w1 = np.clip(w1, 0, None)
    s1 = (v1 * np.sqrt(w1)) @ v1.T
    m = s1 @ c2 @ s1
    w = np.linalg.eigvalsh((m + m.T) / 2)
    return np.sqrt(np.clip(w, 0, None)).sum()


def frechet_distance(mu1, cov1, mu2, cov2):
    diff = mu1 - mu2
    tr_sqrt = _sqrtm_product_trace(cov1, cov2)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def frechet_lowrank(f1, f2):
    """Frechet distance straight from two feature sets `[n_i, dim]`, exact
    for any n and fast when n << dim (no [dim, dim] covariances).

    With centered, 1/sqrt(n-1)-scaled rows x_i, cov_i = x_i^T x_i, and the
    nonzero eigenvalues of cov1 @ cov2 equal those of the [n1, n1] matrix
    (x1 x2^T)(x2 x1^T), so Tr sqrtm(cov1 cov2) = sum sqrt(eig).  The
    training loop's per-snapshot real-vs-fake trend uses it."""
    f1 = np.asarray(f1, dtype=np.float64)
    f2 = np.asarray(f2, dtype=np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    x1 = (f1 - mu1) / np.sqrt(max(len(f1) - 1, 1))
    x2 = (f2 - mu2) / np.sqrt(max(len(f2) - 1, 1))
    m = np.square(mu1 - mu2).sum()
    tr1 = np.square(x1).sum()
    tr2 = np.square(x2).sum()
    cross = x1 @ x2.T
    ev = np.linalg.eigvals(cross @ cross.T)
    tr_sqrt = np.sqrt(np.clip(np.real(ev), 0, None)).sum()
    return float(m + tr1 + tr2 - 2 * tr_sqrt)


def compute_fid(opts, max_real, num_gen):
    detector = metric_utils.get_feature_extractor(opts.device)
    real = metric_utils.iterate_real_features(opts, detector, max_items=max_real)
    gen = metric_utils.iterate_gen_features(opts, detector, max_items=num_gen)
    mu_r, cov_r = real.get_mean_cov()
    mu_g, cov_g = gen.get_mean_cov()
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)
