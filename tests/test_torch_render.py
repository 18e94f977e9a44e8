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
from pix2pix3d_tpu_torch.ops import shear_textures as tst
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


def _one_texture(t2, t_vals, d1, d2, F0, F1, nrr, win=None, tiles=None,
                 channels_first=False):
    """The port's `resample_slabs` on one texture in JAX's `slab_resample`
    terms: t2 [ext, ext, C], t_vals [T].  `tiles` gives the window the
    render contracts for them: full rows, the tiles' union x-window."""
    if tiles is not None:
        win = (t2.shape[0], tiles[4])
    d1, d2 = (torch.as_tensor(d, dtype=torch.float32).reshape(1) for d in (d1, d2))
    return tfr.resample_slabs(t2.transpose(1, 2)[None], t_vals[None], d1, d2, F0[None],
                              F1[None], nrr, win=win, channels_first=channels_first)[0]


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
    """The render's linear taps and the shear module's cubic taps against
    JAX's `_band_weights`; its input offset is folded into the centers."""
    centers = np.random.RandomState(1).rand(3, 7).astype(np.float32) * 12 - 2
    taps = tfr._band_weights if kernel == "linear" else tst._cubic_weights
    np.testing.assert_allclose(
        taps(t(centers) - 0.5, 10).numpy(),
        np.asarray(jfr._band_weights(jnp.asarray(centers), 10, 0.5, kernel=kernel)),
        **GEOM)


def test_shear_pass_and_texture():
    tex = np.random.RandomState(2).randn(32, 32, 8).astype(np.float32)
    np.testing.assert_allclose(
        tst.shear_pass(t(tex), 0.3, 48, 8).numpy(),
        np.asarray(jfr.shear_pass(jnp.asarray(tex), 0.3, 48, 8)), **TOL)
    np.testing.assert_allclose(
        tst.shear_texture(t(tex), torch.tensor(0.2), torch.tensor(-0.15)).numpy(),
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
    got = _one_texture(t(t2), t(t_vals), *args[:2], t(args[2]), t(args[3]), 16,
                       win=win, channels_first=channels_first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk,window", [(8, None), (4, (384, 448))])
def test_prepared_slabs_and_coverage_guard(chunk, window):
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=2)
    planes = _planes(2)
    jc = jfr.frustum_coeffs(c2w, intr, 16, 64, 1.0)
    tc = tfr.frustum_coeffs(t(c2w), t(intr), 16, 64, 1.0)
    jprep = jfr.prepare_textures(jnp.asarray(planes), jc)
    tprep = tfr.prepare_textures(t(planes), tc)
    np.testing.assert_allclose(tprep["tex"].transpose(2, 3).numpy(), np.asarray(jprep["tex"]),
                               **TOL)
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


def _three_cameras_prepared(S, nrr, C, seed):
    """Both packages' `prepare_textures` outputs for three images, each with
    its own camera (the orbit's centre and two extremes), over random
    sheared textures, and those textures [9, ext, ext, C] (ext = S +
    2*MARGIN) in JAX's layout."""
    c2w, intr = (np.concatenate(x) for x in zip(*(
        _camera(np.pi / 2 + dy, np.pi / 2 + dp) for dy, dp in
        ((0.0, 0.0), (0.6, -0.4), (-0.6, 0.4)))))
    jc = jfr.frustum_coeffs(c2w, intr, nrr, S, 1.0)
    tc = tfr.frustum_coeffs(t(c2w), t(intr), nrr, S, 1.0)
    ext = S + 2 * jfr.MARGIN
    tex = np.random.RandomState(seed).randn(9, ext, ext, C).astype(np.float32)
    preps = []
    for mod, c, arr in ((jfr, jc, jnp.asarray(tex)), (tfr, tc, t(tex.transpose(0, 1, 3, 2)))):
        _, _, d1, d2, F0, F1, _ = mod.factor_shears(c["B"], c["E0"], c["E1"])
        preps.append({"tex": arr, "d1": d1.reshape(-1), "d2": d2.reshape(-1),
                      "F0": F0.reshape(-1, 2), "F1": F1.reshape(-1, 2), "n": 3, "q": 3})
    return preps, tex


@pytest.mark.parametrize("win", [None, (384, 448), (200, 96)])
@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("poisoned", [False, True])
def test_batched_slabs(win, channels_first, poisoned):
    """`sample_slabs_prepared` resamples every image and plane of a chunk in
    one batch: against JAX's per-image map and against a loop of
    `resample_slabs` calls on one texture each, on three cameras whose
    window starts differ across images and planes; a NaN-poisoned depth row
    gives NaN where JAX's does."""
    nrr = 16
    (jprep, tprep), tex = _three_cameras_prepared(256, nrr, 4, seed=7)
    t_vals = np.tile(np.linspace(2.8, 3.1, 4, dtype=np.float32), (3, 1))
    t_vals += np.float32(0.05) * np.arange(3, dtype=np.float32)[:, None]
    if poisoned:
        t_vals[1] = np.nan
    ext = tprep["tex"].shape[1]
    centers = tfr._centers(t(t_vals), *(tprep[k] for k in ("d1", "d2", "F0", "F1")), nrr)
    starts = torch.stack([   # [axis, image, plane] at this window or the default one
        tfr._win_starts(c.amin(dim=(1, 2)), ext, min(w, ext)).reshape(3, 3)
        for c, w in zip(centers, win or (384, 448))])
    live = starts[:, [0, 2]]
    assert (live != live[:, :1]).any() and (live != live[:, :, :1]).any()
    want = np.asarray(jfr.sample_slabs_prepared(jprep, jnp.asarray(t_vals), nrr, win=win,
                                                channels_first=channels_first))
    got = tfr.sample_slabs_prepared(tprep, t(t_vals), nrr, win=win,
                                    channels_first=channels_first)
    loop = torch.stack([
        sum(_one_texture(t(tex[k]), t(t_vals[i]), tprep["d1"][k], tprep["d2"][k],
                         tprep["F0"][k], tprep["F1"][k], nrr, win=win,
                         channels_first=channels_first)
            for k in range(3 * i, 3 * i + 3)) / 3 for i in range(3)])
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert nan.any() == poisoned and nan[[0, 2]].sum() == 0
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL)
    np.testing.assert_allclose(got.numpy(), loop.numpy(), equal_nan=True, **TOL)


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


# --- per-output-tile sub-windows (`tiles`, rendering_kwargs['frustum_tiles']) --

@pytest.mark.parametrize("tiles", [(4, 96, 4, 96, 256), (8, 48, 4, 24, 200),
                                   (6, 64, 5, 48, 512)])   # ragged last tiles
@pytest.mark.parametrize("channels_first", [False, True])
def test_tiled_slab_resample(tiles, channels_first):
    """The port's contraction for `tiles` (full rows, the union x-window)
    against JAX's tiled one and against the port's full contraction (the
    windows cover every tap here)."""
    rng = np.random.RandomState(3)
    ext = 64 + 2 * jfr.MARGIN
    t2 = rng.randn(ext, ext, 4).astype(np.float32)
    t_vals = np.linspace(2.0, 2.4, 5).astype(np.float32)
    args = (0.9, 1.1, np.array([40.0, 30.0], np.float32),
            np.array([5.0, -4.0], np.float32))
    want = jfr.slab_resample(jnp.asarray(t2), jnp.asarray(t_vals), *args[:2],
                             jnp.asarray(args[2]), jnp.asarray(args[3]), 16,
                             tiles=tiles, channels_first=channels_first)
    targs = (t(t2), t(t_vals), *args[:2], t(args[2]), t(args[3]), 16)
    got = _one_texture(*targs, tiles=tiles, channels_first=channels_first)
    full = _one_texture(*targs, channels_first=channels_first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("kw,copied", [(dict(tiles=(4, 96, 4, 96, 256)), []),
                                       (dict(win=(200, 96)), [])])
def test_slab_resample_reads_its_window_starts_once(monkeypatch, kw, copied):
    """The resample finds its window starts on the device and reads nothing
    back, for the tiles' window as for any other; no other sync."""
    calls = []
    real = torch.Tensor.tolist

    def counting(self):
        calls.append(self.numel())
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    rng = np.random.RandomState(3)
    ext = 64 + 2 * jfr.MARGIN
    monkeypatch.setattr(torch.Tensor, "item", lambda self: calls.append("item"))
    _one_texture(t(rng.randn(ext, ext, 4)), t(np.linspace(2.0, 2.4, 5)), 0.9, 1.1,
                 t([40.0, 30.0]), t([5.0, -4.0]), 16, **kw)
    assert calls == copied


def _factored(yaw, pitch, S, nrr, T):
    """Both packages' `prepare_textures` outputs without the textures (the
    guard reads only their extent and the shear factors), and depths [1, T]
    over the seg2cat range."""
    c2w, intr = _camera(yaw, pitch)
    jc = jfr.frustum_coeffs(c2w, intr, nrr, S, 1.0)
    tc = tfr.frustum_coeffs(t(c2w), t(intr), nrr, S, 1.0)
    ext = S + 2 * jfr.MARGIN
    preps = []
    for mod, c, arr in ((jfr, jc, jnp.zeros), (tfr, tc, torch.zeros)):
        _, _, d1, d2, F0, F1, _ = mod.factor_shears(c["B"], c["E0"], c["E1"])
        preps.append({"tex": arr((3, ext, 1)), "d1": d1.reshape(-1),
                      "d2": d2.reshape(-1), "F0": F0.reshape(-1, 2),
                      "F1": F1.reshape(-1, 2), "n": 1, "q": 3})
    t_vals = np.linspace(2.25 / 1.02, 3.3, T, dtype=np.float32)[None]
    return preps, t_vals


@pytest.mark.parametrize("yaw,pitch", [(np.pi / 2, np.pi / 2),
                                       (np.pi / 2 + 0.6, np.pi / 2 - 0.4),
                                       (np.pi / 2 - 0.6, np.pi / 2 + 0.4)])
@pytest.mark.parametrize("tiles,bad", [((32, 96, 32, 96, 256), False),
                                       ((32, 16, 32, 16, 64), True),
                                       ((32, 96, 32, 24, 256), None)])
def test_tiled_coverage_guard_matches_jax(yaw, pitch, tiles, bad):
    """The guard of the tiled path at the production geometry of JAX's
    tests/test_frustum.py (S=256, nrr=128, 96 slabs in chunks of 8, the
    orbit extremes): the default tiles (nrr//4, 96, nrr//4, 96, 256) cover
    every tap, undersized ones do not, a narrow stage-2 window is decided
    as JAX decides it."""
    (jprep, tprep), t_vals = _factored(yaw, pitch, 256, 128, 96)
    want = bool(jfr.window_coverage_violation(jprep, jnp.asarray(t_vals), 128,
                                              None, 8, tiles=tiles))
    got = bool(tfr.window_coverage_violation(tprep, t(t_vals), 128, None, 8,
                                             tiles=tiles))
    assert got == want
    if bad is not None:
        assert got == bad


@pytest.mark.parametrize("tiles,poisoned", [((4, 96, 4, 96, 256), False),
                                            ((4, 8, 4, 8, 32), True)])
def test_tiled_frustum_render_unfused(tiles, poisoned):
    """The unfused render with tiles against JAX's; tiles too small for the
    camera NaN-poison both."""
    jd, params, td = _decoder(False, 5)
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=2)
    planes = _planes(2, seed=1)
    want = jax.jit(lambda p, pl, c2w, intr: jfr.frustum_render(
        pl, lambda f, d: jd(p, f, d), c2w, intr, OPTS, 16, depth_steps=24, chunk=8,
        tiles=tiles))(params, jnp.asarray(planes), c2w, intr)
    with torch.no_grad():
        got = tfr.frustum_render(t(planes), td, t(c2w), t(intr), OPTS, 16,
                                 depth_steps=24, chunk=8, tiles=tiles)
        full = tfr.frustum_render(t(planes), td, t(c2w), t(intr), OPTS, 16,
                                  depth_steps=24, chunk=8, window=(192, 192))
    for a, b, f in zip(got, want, full):
        assert np.isnan(np.asarray(b)).all() == poisoned
        assert torch.isnan(a).all() == poisoned
        if not poisoned:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            np.testing.assert_allclose(a.numpy(), f.numpy(), **TOL)


def test_tiled_frustum_render_rematerialized_gradients():
    """Training's per-chunk rematerialization (`frustum_remat`) with tiles:
    the same outputs and the same plane gradients as without it."""
    _, _, td = _decoder(False, 6)
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=1)
    planes = t(_planes(1, seed=2))
    results = []
    for remat in (True, False):
        p = planes.clone().requires_grad_(True)
        out = tfr.frustum_render(p, td, t(c2w), t(intr), dict(OPTS, frustum_remat=remat),
                                 16, depth_steps=24, chunk=8, tiles=(4, 96, 4, 96, 256))
        (out[0].square().sum() + out[1].sum()).backward()
        results.append((out[0].detach(), p.grad))
    np.testing.assert_allclose(results[0][0].numpy(), results[1][0].numpy(), **TOL)
    np.testing.assert_allclose(results[0][1].numpy(), results[1][1].numpy(), **TOL)
    assert results[0][1].abs().sum() > 0


@pytest.mark.parametrize("remat", [True, False])
def test_tiled_frustum_render_gradients_match_jax(remat):
    """Plane gradients with tiles, with and without training's
    `frustum_remat`, against `jax.grad` of JAX's tiled render (its
    per-i-tile and per-j-tile slices included)."""
    jd, params, td = _decoder(False, 6)
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=1)
    planes = _planes(1, seed=2)
    opts = dict(OPTS, frustum_remat=remat)
    tiles = (4, 96, 4, 96, 256)

    def loss(pl):
        out = jfr.frustum_render(pl, lambda f, d: jd(params, f, d), c2w, intr,
                                 opts, 16, depth_steps=24, chunk=8, tiles=tiles)
        return jnp.square(out[0]).sum() + out[1].sum()

    want = jax.jit(jax.grad(loss))(jnp.asarray(planes))
    p = t(planes).requires_grad_(True)
    out = tfr.frustum_render(p, td, t(c2w), t(intr), opts, 16, depth_steps=24,
                             chunk=8, tiles=tiles)
    (out[0].square().sum() + out[1].sum()).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(want)).sum() > 0
