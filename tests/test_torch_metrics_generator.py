"""`compute_miou` and `iterate_gen_features` end to end on a small seg2cat
generator in both packages, on the CPU.

The generator is the small configuration of
tests/test_torch_variants_generators.py (afhq, 128², cbase 512, cmax 16,
encoder channel base 1/128, 8 + 8 importance samples, f32), rendering at
nrr 32, with the port's seeded weights (noise strengths at 0.1) handed to
JAX through `bridge.params_to_jax`; JAX's forward is jitted once for the
batch of 4 both metrics use (one call each).  The dataset holds 6 seeded
128² images, 6-class masks and cameras; JAX's z draws go to the port's draw
hook.

- mIoU and pixel accuracy: equal, but where the two argmax maps differ,
  and they may differ only at pixels whose two largest JAX logits are
  within 1e-4 of the logits' largest magnitude (the generator's f32 gate
  between the packages, tests/test_torch_variants_generators.py).
- The generated images' features (a numpy detector: 8x8 means, a fixed
  projection): within 1e-4 of the largest feature (the images agree to
  that gate).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.metrics import metric_utils as jmu
from pix2pix3d_tpu.metrics import miou as jmiou
from pix2pix3d_tpu.models import build_generator as jbuild

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.metrics import metric_utils as tmu
from pix2pix3d_tpu_torch.metrics import miou as tmiou
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                               pose_to_conditioning)

from test_torch_train_phases import two_torch_threads
from test_torch_variants import _noisy
from test_torch_variants_generators import small_cfg

__all__ = ["two_torch_threads"]

NRR, BATCH, ITEMS, RES, CLASSES = 32, 4, 6, 128, 6
TOL = 1e-4


class Folder:
    def __init__(self):
        rng = np.random.RandomState(4)
        self.data_type = "seg"
        self.images = rng.randint(0, 256, (ITEMS, RES, RES, 3)).astype(np.uint8)
        yy, xx = np.mgrid[0:RES, 0:RES] / RES
        r = np.hypot(xx - 0.5, yy - 0.5)[None, :, :, None]
        self.masks = np.minimum((r * CLASSES * (1 + 0.3 * rng.rand(ITEMS, 1, 1, 1)))
                                .astype(np.uint8), CLASSES - 1)
        intr = fov_to_intrinsics(18.837, device="cpu")
        self.poses = np.concatenate([pose_to_conditioning(LookAtPoseSampler.sample(
            np.pi / 2 + rng.uniform(-0.4, 0.4), np.pi / 2 + rng.uniform(-0.2, 0.2),
            [0, 0, -0.06], radius=2.7, device="cpu"), intr).numpy() for _ in range(ITEMS)])

    def __len__(self):
        return ITEMS

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i], "pose": self.poses[i],
                "idx": i}


class Recorded:
    """A generator behind its package's call shape, recording the semantic
    outputs of each call; JAX's jitted once."""

    def __init__(self, G, jax_params=None):
        self.G, self.z_dim, self.semantic_channels = G, G.z_dim, G.semantic_channels
        self.semantics = []
        if jax_params is not None:
            self.fn = jax.jit(lambda p, z, c, m, pose: G(
                p, z, c, {"mask": m, "pose": pose}, noise_mode="const", det=True))

    def __call__(self, *args, noise_mode=None, det=None):
        assert (noise_mode, det) == ("const", True)
        if len(args) == 4:    # JAX: (params, z, c, batch)
            params, z, c, batch = args
            out = self.fn(params, z, c, batch["mask"], batch["pose"])
            self.semantics.append(np.asarray(out["semantic"]))
        else:
            z, c, batch = args
            out = self.G(z, c, batch, noise_mode=noise_mode, det=det)
            self.semantics.append(out["semantic"].numpy())
        return out


@pytest.fixture(scope="module")
def generators():
    Gt = tbuild(device="cpu", **small_cfg(tconfig))
    params = _noisy(bridge.params_to_jax(Gt))
    Gt.load_state_dict(bridge.params_from_jax(params), strict=True)
    G = jbuild(**small_cfg(jconfig))
    G.neural_rendering_resolution = Gt.neural_rendering_resolution = NRR
    return Recorded(G, params), params, Recorded(Gt)


def _shared_z(monkeypatch, jG):
    """Hand the z each JAX call got to the port's draw hook, in order."""
    zs = []
    call = jG.fn

    def recording(p, z, *rest):
        zs.append(np.asarray(z))
        return call(p, z, *rest)
    monkeypatch.setattr(jG, "fn", recording)
    monkeypatch.setattr(tmu, "draw_normal", lambda g, shape: torch.from_numpy(zs.pop(0)))
    return zs


def test_compute_miou_matches_jax(generators, monkeypatch):
    jG, params, tG = generators
    zs = _shared_z(monkeypatch, jG)
    ds = Folder()
    want = jmiou.compute_miou(jmu.MetricOptions(G=jG, G_params=params, dataset=ds),
                              num_items=BATCH, batch_size=BATCH)
    got = tmiou.compute_miou(tmu.MetricOptions(G=tG, dataset=ds, device="cpu"),
                             num_items=BATCH, batch_size=BATCH)
    assert not zs and len(jG.semantics) == len(tG.semantics) == 1
    flips = 0
    for j, t in zip(jG.semantics, tG.semantics):
        assert t.shape == j.shape == (BATCH, RES, RES, CLASSES)
        top2 = np.sort(j, axis=-1)[..., -2:]
        differ = j.argmax(-1) != t.argmax(-1)
        near_tie = top2[..., 1] - top2[..., 0] <= TOL * np.abs(j).max()
        assert not (differ & ~near_tie).any()
        flips += int(differ.sum())
    if flips == 0:
        assert got == want
    else:
        assert abs(got["pixel_acc"] - want["pixel_acc"]) <= flips / (BATCH * RES * RES)
    assert 0 < got["miou"] < 1


class Detector:
    def __init__(self):
        self.proj = np.random.RandomState(5).randn(8 * 8 * 3, 32).astype(np.float32) / 50

    def __call__(self, images):
        x = np.asarray(images.numpy() if isinstance(images, torch.Tensor) else images,
                       np.float32)
        n, h, w, _ = x.shape
        return x.reshape(n, 8, h // 8, 8, w // 8, 3).mean(axis=(2, 4)).reshape(n, -1) \
            @ self.proj


def test_iterate_gen_features_matches_jax(generators, monkeypatch):
    jG, params, tG = generators
    _shared_z(monkeypatch, jG)
    ds, det = Folder(), Detector()
    want = jmu.iterate_gen_features(jmu.MetricOptions(G=jG, G_params=params, dataset=ds,
                                                      rng_seed=3),
                                    det, batch_size=BATCH, max_items=BATCH)
    got = tmu.iterate_gen_features(tmu.MetricOptions(G=tG, dataset=ds, rng_seed=3,
                                                     device="cpu"),
                                   det, batch_size=BATCH, max_items=BATCH)
    a, b = got.get_all(), want.get_all()
    assert a.shape == b.shape == (BATCH, 32) and np.isfinite(a).all()
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()
