"""Feature statistics and the offline feature extractor, part of a port of
`pix2pix3d_tpu/metrics/metric_utils.py` (ref `metrics/metric_utils.py`):
`FeatureStats`, `RandomConvFeatures` and `get_feature_extractor`, which the
training loop's real-vs-fake feature-distance trend uses.  The Inception
network, the metric options and the real/generated feature iterators are
ROADMAP.md Queue 1 item 7.

`RandomConvFeatures` is a fixed-seed random-convolution proxy (four 3x3
stride-2 convolutions with ReLU, a spatial mean, a random projection to
2048), valid for tracking a run's progress, not comparable to published FID.
The JAX package draws its weights from `jax.random.PRNGKey(0)`; this port
cannot import JAX and draws them from `torch.Generator().manual_seed(seed)`,
so the two packages' proxy values differ for the same images.  Weights can
be handed in (the tests hand in JAX's).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# the Inception network of exact FID is not ported yet
INCEPTION_ITEM = "ROADMAP.md Queue 1 item 7"
CHANNELS = (3, 32, 64, 128, 256)


class FeatureStats:
    """Streaming feature statistics (ref `metric_utils.py:73-149`)."""

    def __init__(self, capture_all=False, capture_mean_cov=False, max_items=None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features):
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros([num_features], np.float64)
        self.raw_cov = np.zeros([num_features, num_features], np.float64)

    def is_full(self):
        return (self.max_items is not None) and (self.num_items >= self.max_items)

    def append(self, x):
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov


def _same_pad(x, k=3, stride=2):
    """Zero padding of NCHW `x` as XLA's 'SAME' gives a k x k, stride-s
    convolution (the odd pixel on the high side)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomConvFeatures:
    """Fixed-seed random convolution features (see the module docstring).

    `kernels` (four HWIO arrays, 3 -> 32 -> 64 -> 128 -> 256 channels) and
    `proj` ([256, dim]) may be given, else they are drawn from
    `torch.Generator().manual_seed(seed)` with the JAX package's scales."""

    def __init__(self, dim=2048, seed=0, kernels=None, proj=None, device="cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        if kernels is None:
            gen = torch.Generator().manual_seed(seed)
            kernels = [torch.randn((3, 3, CHANNELS[i], CHANNELS[i + 1]), generator=gen)
                       * np.sqrt(2.0 / (9 * CHANNELS[i])) for i in range(4)]
            proj = torch.randn((256, dim), generator=gen) / 16.0
        # HWIO -> OIHW
        self.kernels = [torch.as_tensor(np.asarray(k), dtype=torch.float32)
                        .permute(3, 2, 0, 1).contiguous().to(self.device)
                        for k in kernels]
        self.proj = torch.as_tensor(np.asarray(proj), dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def __call__(self, images_uint8):
        """`[N, H, W, 3]` images in uint8 range (any real dtype) ->
        `[N, dim]` f32 numpy."""
        x = torch.as_tensor(np.asarray(images_uint8, np.float32), device=self.device)
        x = x.permute(0, 3, 1, 2) / 127.5 - 1
        for k in self.kernels:
            x = F.relu(F.conv2d(_same_pad(x), k, stride=2))
        return (x.mean(dim=(2, 3)) @ self.proj).cpu().numpy()


_RANDOM_FEATURES_WARNED = [False]


def get_feature_extractor(device="cuda"):
    """The random-convolution proxy on `device`.  With
    `PIX2PIX3D_INCEPTION_NPZ` set (converted Inception weights, the JAX
    package's exact FID) it raises: that network is not ported yet."""
    if os.environ.get("PIX2PIX3D_INCEPTION_NPZ"):
        raise NotImplementedError(
            "PIX2PIX3D_INCEPTION_NPZ is set, but the Inception feature "
            f"network is not ported yet: {INCEPTION_ITEM}")
    if not _RANDOM_FEATURES_WARNED[0]:
        warnings.warn(
            "feature distances use RANDOM conv features (no Inception "
            "weights): relative values track training progress but are not "
            "comparable to published numbers, nor to the JAX package's proxy "
            "(other random weights).")
        _RANDOM_FEATURES_WARNED[0] = True
    return RandomConvFeatures(device=device)
