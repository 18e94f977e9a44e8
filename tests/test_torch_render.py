"""The port's camera, rays and frustum renderer (`pix2pix3d_tpu_torch/render`)
against the JAX package's, at small sizes on the CPU in f32.

Tolerances: 1e-5 for pure geometry (the same few f32 operations on both
sides); 1e-4 for the resampling chain and the rendered outputs, where f32
matmuls sum in different orders (the JAX suite's own windowed-vs-full
frustum gate, tests/test_frustum.py, is 1e-4).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.models.triplane import OSGDecoderSemanticLateSeparate as JDecoder
from pix2pix3d_tpu.render import camera as jcam
from pix2pix3d_tpu.render import frustum as jfr
from pix2pix3d_tpu.render import ray_sampler as jrays

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
from pix2pix3d_tpu_torch.render import camera as tcam
from pix2pix3d_tpu_torch.render import frustum as tfr
from pix2pix3d_tpu_torch.render import ray_sampler as trays

GEOM = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
OPTS = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
        "depth_resolution": 24, "depth_resolution_importance": 24,
        "white_back": False}


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _camera(yaw, pitch, batch=1):
    c2w = jcam.LookAtPoseSampler.sample(None, yaw, pitch, [0.0, 0.0, -0.06],
                                        radius=2.7, batch_size=batch)
    intr = jnp.tile(jcam.fov_to_intrinsics(18.837)[None], (batch, 1, 1))
    return c2w, intr


def _planes(n, s=64, c=32, seed=0):
    base = jax.random.normal(jax.random.PRNGKey(seed), (n, 3, s // 8, s // 8, c))
    return np.asarray(jax.image.resize(base, (n, 3, s, s, c), "bicubic"))


@pytest.mark.parametrize("yaw,pitch", [(np.pi / 2, np.pi / 2),
                                       (np.pi / 2 + 0.5, np.pi / 2 - 0.3)])
def test_camera_pose_and_rays(yaw, pitch):
    want = jcam.LookAtPoseSampler.sample(None, yaw, pitch, [0, 0, -0.06],
                                         radius=2.7, batch_size=2)
    got = tcam.LookAtPoseSampler.sample(yaw, pitch, [0, 0, -0.06], radius=2.7,
                                        batch_size=2, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEOM)
    intr_j = jcam.fov_to_intrinsics(18.837)
    intr_t = tcam.fov_to_intrinsics(18.837, device="cpu")
    np.testing.assert_allclose(intr_t.numpy(), np.asarray(intr_j), **GEOM)
    np.testing.assert_allclose(
        tcam.pose_to_conditioning(got, intr_t).numpy(),
        np.asarray(jcam.pose_to_conditioning(want, intr_j)), **GEOM)
    intr2 = jnp.tile(intr_j[None], (2, 1, 1))
    for a, b in zip(trays.sample_rays(got, t(intr2), 16),
                    jrays.sample_rays(want, intr2, 16)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GEOM)


@pytest.mark.parametrize("yaw,pitch", [(np.pi / 2 + 0.2, np.pi / 2 - 0.1),
                                       (np.pi / 2 - 0.6, np.pi / 2 + 0.4)])
def test_coeffs_and_shear_factorization(yaw, pitch):
    c2w, intr = _camera(yaw, pitch, batch=2)
    jc = jfr.frustum_coeffs(c2w, intr, 32, 64, 1.0)
    tc = tfr.frustum_coeffs(t(c2w), t(intr), 32, 64, 1.0)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **GEOM)
    for a, b in zip(tfr.factor_shears(tc["B"], tc["E0"], tc["E1"]),
                    jfr.factor_shears(jc["B"], jc["E0"], jc["E1"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GEOM)


@pytest.mark.parametrize("kernel", ["linear", "cubic"])
def test_band_weights(kernel):
    centers = np.random.RandomState(1).rand(3, 7).astype(np.float32) * 12 - 2
    np.testing.assert_allclose(
        tfr._band_weights(t(centers), 10, 0.5, kernel=kernel).numpy(),
        np.asarray(jfr._band_weights(jnp.asarray(centers), 10, 0.5, kernel=kernel)),
        **GEOM)


def test_shear_pass_and_texture():
    tex = np.random.RandomState(2).randn(32, 32, 8).astype(np.float32)
    np.testing.assert_allclose(
        tfr.shear_pass(t(tex), 0.3, 48, 8).numpy(),
        np.asarray(jfr.shear_pass(jnp.asarray(tex), 0.3, 48, 8)), **TOL)
    np.testing.assert_allclose(
        tfr.shear_texture(t(tex), torch.tensor(0.2), torch.tensor(-0.15)).numpy(),
        np.asarray(jfr.shear_texture(jnp.asarray(tex), 0.2, -0.15)), **TOL)


@pytest.mark.parametrize("win", [None, (256, 384), (200, 96)])
@pytest.mark.parametrize("channels_first", [False, True])
def test_slab_resample(win, channels_first):
    """Full and windowed contraction, both output layouts."""
    rng = np.random.RandomState(3)
    ext = 64 + 2 * jfr.MARGIN
    t2 = rng.randn(ext, ext, 4).astype(np.float32)
    t_vals = np.linspace(2.0, 2.4, 5).astype(np.float32)
    args = (0.9, 1.1, np.array([40.0, 30.0], np.float32),
            np.array([5.0, -4.0], np.float32))
    want = jfr.slab_resample(jnp.asarray(t2), jnp.asarray(t_vals), *args[:2],
                             jnp.asarray(args[2]), jnp.asarray(args[3]), 16,
                             win=win, channels_first=channels_first)
    got = tfr.slab_resample(t(t2), t(t_vals), *args[:2], t(args[2]), t(args[3]),
                            16, win=win, channels_first=channels_first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk,window", [(8, None), (4, (384, 448))])
def test_prepared_slabs_and_coverage_guard(chunk, window):
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=2)
    planes = _planes(2)
    jc = jfr.frustum_coeffs(c2w, intr, 16, 64, 1.0)
    tc = tfr.frustum_coeffs(t(c2w), t(intr), 16, 64, 1.0)
    jprep = jfr.prepare_textures(jnp.asarray(planes), jc)
    tprep = tfr.prepare_textures(t(planes), tc)
    np.testing.assert_allclose(tprep["tex"].numpy(), np.asarray(jprep["tex"]), **TOL)
    t_vals = np.tile(np.linspace(2.2, 3.1, 16, dtype=np.float32), (2, 1))
    for cf in (False, True):
        want = jfr.sample_slabs_prepared(jprep, jnp.asarray(t_vals[:, :chunk]), 16,
                                         win=window, channels_first=cf)
        got = tfr.sample_slabs_prepared(tprep, t(t_vals[:, :chunk]), 16, win=window,
                                        channels_first=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for win in ((384, 448), (64, 64), (512, 512)):
        assert bool(tfr.window_coverage_violation(tprep, t(t_vals), 16, win, chunk)) \
            == bool(jfr.window_coverage_violation(jprep, jnp.asarray(t_vals), 16,
                                                  win, chunk))


def _decoder(sem_sigmoid, seed):
    jd = JDecoder(32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
                       "sigmoid": sem_sigmoid})
    td = OSGDecoderSemanticLateSeparate(
        32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
             "sigmoid": sem_sigmoid})
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed))
    td.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return jd, params, td.eval()


def test_decoder_late_separate():
    jd, params, td = _decoder(False, 4)
    x = np.random.RandomState(4).randn(2, 3, 50, 32).astype(np.float32)
    dirs = np.zeros((2, 50, 3), np.float32)
    want = jd(params, jnp.asarray(x), jnp.asarray(dirs))
    with torch.no_grad():
        got = td(t(x), t(dirs))
    for k in ("rgb", "sigma"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


@pytest.mark.parametrize("yaw,pitch,window", [
    (np.pi / 2 + 0.2, np.pi / 2 - 0.1, None),
    (np.pi / 2 - 0.3, np.pi / 2 + 0.2, (384, 448)),
    (np.pi / 2, np.pi / 2, (48, 48)),     # too narrow: the guard NaN-poisons
])
def test_frustum_render_unfused(yaw, pitch, window):
    jd, params, td = _decoder(False, 5)
    c2w, intr = _camera(yaw, pitch, batch=2)
    planes = _planes(2, seed=1)
    want = jfr.frustum_render(jnp.asarray(planes), lambda f, d: jd(params, f, d),
                              c2w, intr, OPTS, 16, depth_steps=24, chunk=8,
                              window=window)
    with torch.no_grad():
        got = tfr.frustum_render(t(planes), td, t(c2w), t(intr), OPTS, 16,
                                 depth_steps=24, chunk=8, window=window)
    if window == (48, 48):
        assert all(np.isnan(np.asarray(w)).all() for w in want)
        assert all(torch.isnan(g).all() for g in got)
        return
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
