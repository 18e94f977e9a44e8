"""Metric infrastructure, port of `pix2pix3d_tpu/metrics/metric_utils.py`
(ref `metrics/metric_utils.py`).

`MetricOptions` carries the generator, the dataset and the device;
`FeatureStats` accumulates streaming feature statistics;
`iterate_real_features` and `iterate_gen_features` run a feature detector
over the dataset's images and over the generator's samples under the
dataset's own masks and poses.

Feature detectors: `get_feature_extractor(device)` returns the port's
Inception-v3 (`metrics/inception.py`) when `PIX2PIX3D_INCEPTION_NPZ` names a
file (weights converted by scripts/convert_inception.py: exact FID), else a
fixed-seed random-convolution proxy (four 3x3 stride-2 convolutions with
ReLU, a spatial mean, a random projection to 2048), valid for tracking a
run's progress, not comparable to published FID.  The JAX package draws the
proxy's weights from `jax.random.PRNGKey(0)`; this port cannot import JAX
and draws them from `torch.Generator().manual_seed(seed)`, so the two
packages' proxy values differ for the same images.  Weights can be handed
in (the tests hand in JAX's).  A detector takes `[N, H, W, 3]` images in
uint8 range (a numpy array or a tensor) and returns `[N, dim]` f32 numpy.

Random draws: the generator's z comes from a CPU `torch.Generator` seeded
with `opts.rng_seed`, through `draw_normal` (and PPL's interpolation t
through `draw_uniform`), so the draws do not depend on the device.  The JAX
package draws from `jax.random.PRNGKey(rng_seed)`, other numbers; the tests
hand JAX's draws to these two hooks.  Dataset indices come from
`np.random.RandomState(rng_seed)` in both packages.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

CHANNELS = (3, 32, 64, 128, 256)


class MetricOptions:
    """What a metric reads: the port's generator `G` (on `device`), the
    dataset, the seed of its draws.  `G_params` is accepted for the JAX
    package's call shape and unused (the port's modules hold their
    weights).  `device` defaults to the card and raises without one."""

    def __init__(self, G=None, G_params=None, dataset=None, num_items=None,
                 rng_seed=0, progress=None, device="cuda"):
        self.G = G
        self.G_params = G_params
        self.dataset = dataset
        self.num_items = num_items
        self.rng_seed = rng_seed
        self.progress = progress
        self.device = resolve_device(device)


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


def images_to(images, device):
    """`[N, H, W, 3]` images (numpy or tensor, any real dtype) as an f32
    NCHW tensor on `device`."""
    return torch.as_tensor(images, dtype=torch.float32, device=device).permute(0, 3, 1, 2)


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
        """`[N, H, W, 3]` images in uint8 range -> `[N, dim]` f32 numpy."""
        x = images_to(images_uint8, self.device) / 127.5 - 1
        for k in self.kernels:
            x = F.relu(F.conv2d(_same_pad(x), k, stride=2))
        return (x.mean(dim=(2, 3)) @ self.proj).cpu().numpy()


_RANDOM_FEATURES_WARNED = [False]


def get_feature_extractor(device="cuda"):
    """The port's Inception-v3 on `device` when `PIX2PIX3D_INCEPTION_NPZ`
    names an existing file (as the JAX package's), else the
    random-convolution proxy, with a warning the first time."""
    path = os.environ.get("PIX2PIX3D_INCEPTION_NPZ", "")
    if path and os.path.exists(path):
        from .inception import InceptionV3Features
        return InceptionV3Features(path, device=device)
    if not _RANDOM_FEATURES_WARNED[0]:
        warnings.warn(
            "feature distances use RANDOM conv features (no Inception "
            "weights): relative values track training progress but are not "
            "comparable to published numbers, nor to the JAX package's proxy "
            "(other random weights).  Set PIX2PIX3D_INCEPTION_NPZ to "
            "converted weights for exact FID.")
        _RANDOM_FEATURES_WARNED[0] = True
    return RandomConvFeatures(device=device)


def draw_normal(generator, shape):
    """N(0, 1) draws from the CPU `generator` (z)."""
    return torch.randn(shape, generator=generator)


def draw_uniform(generator, shape):
    """U[0, 1) draws from the CPU `generator` (PPL's t)."""
    return torch.rand(shape, generator=generator)


def sample_inputs(opts, rng, generator, batch_size):
    """One batch of generator inputs, drawn as the JAX package draws them: z
    `[batch_size, z_dim]` from `generator`, then dataset items at
    `rng.randint` indices; their masks (an edge map rescaled to [-1, 1] and
    inverted) and poses.  All on `opts.device`: (z, mask, pose)."""
    ds = opts.dataset
    z = draw_normal(generator, (batch_size, opts.G.z_dim)).to(opts.device)
    items = [ds[rng.randint(len(ds))] for _ in range(batch_size)]
    mask = torch.from_numpy(np.stack([it["mask"] for it in items]).astype(np.float32))
    if ds.data_type == "edge":
        mask = -(mask / 127.5 - 1)
    pose = torch.from_numpy(np.stack([it["pose"] for it in items]).astype(np.float32))
    return z, mask.to(opts.device), pose.to(opts.device)


def seeded(opts):
    """The metric's two draw streams: (dataset-index RandomState, z
    generator), both seeded with `opts.rng_seed`."""
    return (np.random.RandomState(opts.rng_seed),
            torch.Generator().manual_seed(opts.rng_seed))


def generated_images(out):
    """The generator's `image` `[N, H, W, 3]` in [-1, 1] as uint8-range
    floats, clipped."""
    return ((out["image"] + 1) * 127.5).clamp(0, 255)


def iterate_real_features(opts, detector, batch_size=16, max_items=None):
    stats = FeatureStats(capture_mean_cov=True, capture_all=True,
                         max_items=max_items)
    ds = opts.dataset
    idx = 0
    while not stats.is_full() and idx < len(ds):
        imgs = []
        for _ in range(batch_size):
            if idx >= len(ds):
                break
            item = ds[idx]
            img = item["image"] if isinstance(item, dict) else item[0]
            imgs.append(img)
            idx += 1
        if not imgs:
            break
        stats.append(detector(np.stack(imgs).astype(np.float32)))
    return stats


@torch.no_grad()
def iterate_gen_features(opts, detector, batch_size=8, max_items=None):
    """Features of the conditional generator's samples under dataset
    masks and poses, const noise, deterministic rendering (the JAX
    package's conditional call shape; the reference's `G(z, c)` crashes
    for the conditional models, SURVEY §2j)."""
    stats = FeatureStats(capture_mean_cov=True, capture_all=True,
                         max_items=max_items)
    rng, generator = seeded(opts)
    while not stats.is_full():
        z, mask, pose = sample_inputs(opts, rng, generator, batch_size)
        out = opts.G(z, pose, {"mask": mask, "pose": pose},
                     noise_mode="const", det=True)
        stats.append(detector(generated_images(out)))
    return stats
