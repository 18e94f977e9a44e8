"""The port's two-pass importance renderer and the generator methods built on
it (`pix2pix3d_tpu_torch/render/{math_utils,ray_marcher,renderer}.py`,
`ops/grid_sample.py`, `models/triplane.py`) against the JAX package's, at
small sizes on the CPU in f32.  Inputs are made with numpy, weights bridged
import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
from the JAX `init`.

Tolerances: 1e-5 for geometry, grid sampling, weights and depth sampling
(a few f32 operations on both sides; tests/test_parity_render.py holds the
same functions to the torch reference at 1e-4/1e-5); 1e-4 for whole
renders and the generator's outputs (the renderer's gate in
tests/test_parity_render.py; f32 matmuls sum in other orders, and the fine
depths carry the coarse pass's differences).  Only `det=True` renders are
compared: the two frameworks draw different random numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.models.triplane import OSGDecoderSemanticLateSeparate as JDecoder
from pix2pix3d_tpu.ops import grid_sample as jgs
from pix2pix3d_tpu.render import camera as jcam
from pix2pix3d_tpu.render import math_utils as jmu
from pix2pix3d_tpu.render import ray_marcher as jrm
from pix2pix3d_tpu.render import ray_sampler as jrays
from pix2pix3d_tpu.render import renderer as jrr

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
from pix2pix3d_tpu_torch.ops import grid_sample as tgs
from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd
from pix2pix3d_tpu_torch.render import math_utils as tmu
from pix2pix3d_tpu_torch.render import ray_marcher as trm
from pix2pix3d_tpu_torch.render import renderer as trr

GEOM = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw")


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _camera(yaw, pitch, batch=1, fov=18.837):
    c2w = jcam.LookAtPoseSampler.sample(None, yaw, pitch, [0.0, 0.0, -0.06],
                                        radius=2.7, batch_size=batch)
    intr = jnp.tile(jcam.fov_to_intrinsics(fov)[None], (batch, 1, 1))
    return c2w, intr


def _rays(nrr, batch=2, fov=18.837):
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.15, batch, fov)
    ro, rd = jrays.sample_rays(c2w, intr, nrr)
    return np.asarray(ro), np.asarray(rd)


def _planes(n, s=32, c=32, seed=0):
    base = jax.random.normal(jax.random.PRNGKey(seed), (n, 3, s // 4, s // 4, c))
    return np.asarray(jax.image.resize(base, (n, 3, s, s, c), "bicubic"))


def _sorted_depths(rng, shape, lo=2.0, hi=3.5):
    return np.sort(rng.uniform(lo, hi, shape), axis=-1).astype(np.float32)


# --- math_utils, ray_marcher ---------------------------------------------

def test_ray_limits_box_valid_and_invalid_rays():
    rng = np.random.RandomState(0)
    origins = rng.uniform(-2.0, 2.0, (3, 40, 3)).astype(np.float32)
    dirs = rng.randn(3, 40, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jmu.get_ray_limits_box(jnp.asarray(origins), jnp.asarray(dirs), 1.2)
    got = tmu.get_ray_limits_box(t(origins), t(dirs), 1.2)
    valid = np.asarray(want[0] <= want[1])
    assert 0 < valid.sum() < valid.size          # both kinds of ray present
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape == (3, 40, 1)
        close(a, b, GEOM)
    assert np.all(got[0].numpy()[~valid] == -1) and np.all(got[1].numpy()[~valid] == -2)
    close(tmu.normalize_vecs(t(origins)), jmu.normalize_vecs(jnp.asarray(origins)), GEOM)
    close(tmu.linspace_batched(t(origins[..., 0]), t(origins[..., 1]), 7),
          jmu.linspace_batched(jnp.asarray(origins[..., 0]),
                               jnp.asarray(origins[..., 1]), 7), GEOM)


@pytest.mark.parametrize("white_back", [False, True])
def test_compute_weights_and_march_rays(white_back):
    rng = np.random.RandomState(1)
    opts = {"clamp_mode": "softplus", "white_back": white_back}
    densities = rng.randn(2, 30, 16).astype(np.float32) * 3
    depths = _sorted_depths(rng, (2, 30, 16))
    colors = rng.rand(2, 30, 16, 8).astype(np.float32)
    close(trm.compute_weights_3d(t(densities), t(depths), opts),
          jrm.compute_weights_3d(jnp.asarray(densities), jnp.asarray(depths), opts),
          GEOM)
    got = trm.march_rays_3d(t(colors), t(densities), t(depths), opts)
    want = jrm.march_rays_3d(jnp.asarray(colors), jnp.asarray(densities),
                             jnp.asarray(depths), opts)
    for a, b in zip(got, want):
        close(a, b, GEOM)
    got = trm.march_rays(t(colors), t(densities[..., None]), t(depths[..., None]), opts)
    want = jrm.march_rays(jnp.asarray(colors), jnp.asarray(densities[..., None]),
                          jnp.asarray(depths[..., None]), opts)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        close(a, b, GEOM)


def test_finalize_clamps_nan_depth_to_the_range_of_all_depths():
    opts = {"white_back": False}
    depth = t([[np.nan, 1.0, 9.0]])
    depths = t([[[2.0, 3.0], [2.5, 3.5], [2.0, 4.0]]])
    got = trm.finalize_composite_3d(torch.zeros((1, 3, 2)), depth, torch.ones((1, 3)),
                                    depths, opts)
    want = jrm.finalize_composite_3d(jnp.zeros((1, 3, 2)), jnp.asarray(depth.numpy()),
                                     jnp.ones((1, 3)), jnp.asarray(depths.numpy()), opts)
    close(got[1], want[1], GEOM)
    assert got[1].tolist() == [[4.0, 2.0, 4.0]]


# --- grid sampling ---------------------------------------------------------

def _grid_inputs(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 9, 11, 5).astype(np.float32)
    # beyond [-1, 1] too: points off the plane and in its border texels
    coords = rng.uniform(-1.3, 1.3, (2, 200, 2)).astype(np.float32)
    coords[:, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.2, 0.3], [0.99, -1.05]]
    return feats, coords


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d(padding_mode):
    feats, coords = _grid_inputs(2)
    close(tgs.grid_sample_2d(t(feats), t(coords), padding_mode),
          jgs.grid_sample_2d(jnp.asarray(feats), jnp.asarray(coords), padding_mode),
          GEOM)


def test_grid_sample_2d_patch_equals_zeros_padding_off_the_plane():
    feats, coords = _grid_inputs(3)
    got = tgs.grid_sample_2d_patch(t(feats), t(coords))
    close(got, jgs.grid_sample_2d_patch(jnp.asarray(feats), jnp.asarray(coords)), GEOM)
    outside = (np.abs(coords) > 1.0 + 1.0 / 9).any(axis=-1)
    assert outside.sum() > 20
    assert np.all(got.numpy()[outside] == 0)
    close(got, tgs.grid_sample_2d(t(feats), t(coords), "zeros"), GEOM)


def test_project_and_sample_from_planes():
    rng = np.random.RandomState(4)
    planes = _planes(2, s=16)
    coords = rng.uniform(-0.6, 0.6, (2, 300, 3)).astype(np.float32)
    close(trr.project_onto_planes(t(coords)),
          jrr.project_onto_planes(jnp.asarray(coords)), GEOM)
    want = jrr.sample_from_planes(jnp.asarray(planes), jnp.asarray(coords), 1.0)
    close(trr.sample_from_planes(t(planes), t(coords), 1.0), want, GEOM)
    close(trr.make_plane_sampler(t(planes), 1.0)(t(coords)), want, GEOM)


# --- depth sampling ---------------------------------------------------------

def test_smooth_weights():
    w = np.random.RandomState(5).rand(40, 23).astype(np.float32)
    close(trr._smooth_weights(t(w)), jrr._smooth_weights(jnp.asarray(w)),
          dict(rtol=1e-6, atol=1e-7))


def test_sample_pdf_det():
    """Weights carry the +0.01 floor that `sample_importance` adds.  Without
    it a bin can hold under eps (1e-5) of the mass, and then the reference's
    inverse CDF jumps by up to a bin at u = 1 depending on whether the CDF's
    last sum rounds to either side of 1.0, which two cumsum orders do
    differently."""
    rng = np.random.RandomState(6)
    bins = _sorted_depths(rng, (64, 25))
    weights = (rng.rand(64, 23) ** 3 + 0.01).astype(np.float32)
    weights[:4, 5:] = 0.01                       # floor-only tails
    want = jrr.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 20, det=True)
    got = trr.sample_pdf(None, t(bins), t(weights), 20, det=True)
    assert tuple(got.shape) == (64, 20)
    close(got, want, GEOM)


@pytest.mark.parametrize("kind", ["scalar", "per_ray", "disparity"])
def test_sample_stratified_det(kind):
    ro, rd = _rays(4)
    if kind == "per_ray":
        rng = np.random.RandomState(7)
        start = rng.uniform(2.0, 2.4, ro.shape[:2]).astype(np.float32)
        end = start + rng.uniform(0.5, 1.0, ro.shape[:2]).astype(np.float32)
        js, je, ts, te = jnp.asarray(start), jnp.asarray(end), t(start), t(end)
    else:
        js = ts = 2.25
        je = te = 3.3
    disparity = kind == "disparity"
    want = jrr.ImportanceRenderer.sample_stratified(None, jnp.asarray(ro), js, je, 12,
                                                    disparity, det=True)
    got = trr.ImportanceRenderer.sample_stratified(None, t(ro), ts, te, 12,
                                                   disparity, det=True)
    assert tuple(got.shape) == want.shape == (2, 16, 12)
    close(got, want, GEOM)


def test_sample_importance_det():
    rng = np.random.RandomState(8)
    z = _sorted_depths(rng, (2, 10, 16))
    w = rng.rand(2, 10, 15).astype(np.float32)
    close(trr.ImportanceRenderer.sample_importance(None, t(z), t(w), 12, det=True),
          jrr.ImportanceRenderer.sample_importance(None, jnp.asarray(z),
                                                   jnp.asarray(w), 12, det=True),
          GEOM)


def test_unify_samples():
    rng = np.random.RandomState(9)
    d1 = _sorted_depths(rng, (2, 10, 6))[..., None]
    d2 = _sorted_depths(rng, (2, 10, 5))[..., None]
    c1, c2 = rng.rand(2, 10, 6, 4), rng.rand(2, 10, 5, 4)
    s1, s2 = rng.randn(2, 10, 6, 1), rng.randn(2, 10, 5, 1)
    args = [a.astype(np.float32) for a in (d1, c1, s1, d2, c2, s2)]
    got = trr.ImportanceRenderer.unify_samples(*map(t, args))
    want = jrr.ImportanceRenderer.unify_samples(*map(jnp.asarray, args))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        close(a, b, dict(rtol=0, atol=0))


# --- the renderer -------------------------------------------------------------

def _decoders(sem_sigmoid, seed):
    opts = {"decoder_output_dim": 32, "decoder_lr_mul": 1.0, "sigmoid": sem_sigmoid}
    jd = JDecoder(32, opts)
    td = OSGDecoderSemanticLateSeparate(32, opts)
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed))
    td.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return (lambda f, d: jd(params, f, d)), td.eval()


RENDER_CASES = {
    # name: (option overrides, fov); 2 images x 8^2 rays x 12 samples = 1,536
    # points per pass
    "one_chunk": ({}, 18.837),
    "chunked": ({"point_chunk": 500}, 18.837),
    "coarse_only": ({"depth_resolution_importance": 0, "point_chunk": 500}, 18.837),
    "auto_bounds": ({"ray_start": "auto", "ray_end": "auto"}, 40.0),
    "white_back": ({"white_back": True, "disparity_space_sampling": True}, 18.837),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_importance_renderer_matches_jax(case):
    overrides, fov = RENDER_CASES[case]
    opts = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
            "depth_resolution": 12, "depth_resolution_importance": 12,
            "clamp_mode": "softplus", "disparity_space_sampling": False,
            "white_back": False}
    opts.update(overrides)
    ro, rd = _rays(8, fov=fov)
    if case == "auto_bounds":
        lo, hi = jmu.get_ray_limits_box(jnp.asarray(ro), jnp.asarray(rd), 1.0)
        valid = np.asarray(lo < hi)
        assert 0 < valid.sum() < valid.size      # some rays miss the box
    planes = _planes(2)
    jdec, tdec = _decoders(False, 10)
    want = jrr.ImportanceRenderer()(jnp.asarray(planes), jdec, jnp.asarray(ro),
                                    jnp.asarray(rd), opts, det=True)
    with torch.no_grad():
        got = trr.ImportanceRenderer()(t(planes), tdec, t(ro), t(rd), opts, det=True)
    for a, b, shape in zip(got, want, [(2, 64, 64), (2, 64, 1), (2, 64, 1)]):
        assert tuple(a.shape) == b.shape == shape
        close(a, b, TOL)


def test_renderer_through_the_decoder_kernel_matches_ref():
    """The decoder-callable interface with impl='kernel' (its plain version
    here), chunked: the same render as impl='ref'."""
    opts = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
            "depth_resolution": 12, "depth_resolution_importance": 12,
            "clamp_mode": "softplus", "point_chunk": 500}
    ro, rd = _rays(8)
    planes = t(_planes(2))
    _, tdec = _decoders(True, 11)
    with torch.no_grad():
        ref = trr.ImportanceRenderer()(planes, tdec, t(ro), t(rd), opts, det=True)
        got = trr.ImportanceRenderer()(planes, lambda f, d: tdec(f, d, impl="kernel"),
                                       t(ro), t(rd), opts, det=True)
    for a, b in zip(got, ref):
        close(a, b.numpy(), TOL)


def test_run_model_plane_dtype_and_density_noise():
    ro, rd = _rays(4)
    planes = t(_planes(2))
    _, tdec = _decoders(False, 12)
    coords = t(ro + 2.7 * rd)
    opts = {"box_warp": 1.0}
    r = trr.ImportanceRenderer()
    with torch.no_grad():
        base = r.run_model(planes, tdec, coords, t(rd), opts)
        bf = r.run_model(planes, tdec, coords, t(rd), dict(opts, plane_dtype="bfloat16"))
        noisy = [r.run_model(planes, tdec, coords, t(rd), dict(opts, density_noise=1.0),
                             generator=torch.Generator().manual_seed(s))
                 for s in (0, 0, 1)]
    assert bf["rgb"].dtype == torch.float32
    assert 0 < (bf["rgb"] - base["rgb"]).abs().max() < 0.05
    assert torch.equal(noisy[0]["sigma"], noisy[1]["sigma"])
    assert not torch.equal(noisy[0]["sigma"], noisy[2]["sigma"])
    assert torch.equal(noisy[0]["rgb"], base["rgb"])
    with pytest.raises(ValueError):
        r.run_model(planes, tdec, coords, t(rd), dict(opts, density_noise=1.0))


# --- the generator on the importance path -------------------------------------

def _small_cfg(cfg_mod):
    """tests/test_torch_generator.py's small configuration without the
    frustum keys: the importance renderer, 48 + 48 samples."""
    cfg = cfg_mod.generator_config(
        cfg="afhq", resolution=128, data_type="seg", semantic_channels=6,
        cbase=1024, cmax=32, sr_num_fp16_res=0, render_mask=True,
        gen_pose_cond=True)
    cfg["mapping_kwargs"]["in_resolution"] = 128
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    return cfg


@pytest.fixture(scope="module")
def generators():
    G = jbuild(**_small_cfg(jconfig))
    params = jax.jit(G.init)(jax.random.PRNGKey(0))
    Gt = tbuild(device="cpu", **_small_cfg(tconfig))
    Gt.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    assert "sampler" not in Gt.rendering_kwargs
    return G, params, Gt


def _request(yaw, pitch, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, 512).astype(np.float32)
    mask = rng.randint(0, 6, (1, 128, 128, 1)).astype(np.float32)
    c2w = jcam.LookAtPoseSampler.sample(None, yaw, pitch, [0.0, 0.0, -0.06],
                                        radius=2.7)
    pose = np.array(jcam.pose_to_conditioning(c2w, jcam.fov_to_intrinsics(18.837)))
    return z, mask, pose


def _port_call(Gt, z, mask, pose, **kw):
    with torch.no_grad():
        return Gt(t(z), t(pose), {"mask": t(mask), "pose": t(pose)},
                  neural_rendering_resolution=32, noise_mode="const", **kw)


@pytest.mark.parametrize("yaw,pitch,seed", [(np.pi / 2 + 0.15, np.pi / 2 - 0.1, 0),
                                            (np.pi / 2 - 0.3, np.pi / 2 + 0.2, 1)])
def test_generator_importance_path_matches_jax(generators, yaw, pitch, seed):
    G, params, Gt = generators
    z, mask, pose = _request(yaw, pitch, seed)
    want = G(params, jnp.asarray(z), jnp.asarray(pose),
             {"mask": jnp.asarray(mask), "pose": jnp.asarray(pose)},
             neural_rendering_resolution=32, noise_mode="const", det=True)
    before = lsd.late_separate_decode.launches
    got = _port_call(Gt, z, mask, pose, det=True)
    assert lsd.late_separate_decode.launches == before   # generator: impl="ref"
    for key in OUTPUTS:
        assert tuple(got[key].shape) == want[key].shape, key
        close(got[key], want[key], TOL)


def test_sample_mixed_and_run_model_planes_match_jax(generators):
    G, params, Gt = generators
    z, mask, pose = _request(np.pi / 2, np.pi / 2, 2)
    rng = np.random.RandomState(3)
    coords = rng.uniform(-0.5, 0.5, (1, 700, 3)).astype(np.float32)
    dirs = rng.randn(1, 700, 3).astype(np.float32)
    batch = {"mask": jnp.asarray(mask), "pose": jnp.asarray(pose)}
    ws = G.mapping(params, jnp.asarray(z), jnp.asarray(pose), batch)
    want = G.sample_mixed(params, jnp.asarray(coords), jnp.asarray(dirs), ws)
    with torch.no_grad():
        ws_t = Gt.mapping(t(z), t(pose), {"mask": t(mask), "pose": t(pose)})
        got = Gt.sample_mixed(t(coords), t(dirs), ws_t)
        via_sample = Gt.sample(t(coords), t(dirs), t(z), t(pose),
                               {"mask": t(mask), "pose": t(pose)})
        planes = _port_call(Gt, z, mask, pose, det=True)["planes"]
        via_planes = Gt.run_model_planes(planes, t(coords), t(dirs))
    for key in ("rgb", "sigma"):
        close(got[key], want[key], TOL)
        assert torch.equal(via_sample[key], got[key])
        assert torch.equal(via_planes[key], got[key])


def test_synthesis_with_cached_planes_equals_synthesis(generators):
    _, _, Gt = generators
    z, mask, pose = _request(np.pi / 2 + 0.1, np.pi / 2, 4)
    with torch.no_grad():
        ws = Gt.mapping(t(z), t(pose), {"mask": t(mask), "pose": t(pose)})
        full = Gt.synthesis(ws, t(pose), neural_rendering_resolution=32, det=True,
                            noise_mode="const")
        cached = Gt.synthesis(ws, t(pose), neural_rendering_resolution=32, det=True,
                              noise_mode="const", planes=full["planes"])
    for key in OUTPUTS:
        assert torch.equal(full[key], cached[key]), key


def test_jittered_render_follows_the_generator_seed(generators):
    _, _, Gt = generators
    z, mask, pose = _request(np.pi / 2, np.pi / 2 + 0.1, 5)

    def render(seed):
        return _port_call(Gt, z, mask, pose,
                          generator=torch.Generator().manual_seed(seed))

    a, b, c = render(0), render(0), render(1)
    for key, shape in (("image", (1, 128, 128, 3)), ("image_raw", (1, 32, 32, 3)),
                       ("image_depth", (1, 32, 32, 1)),
                       ("semantic", (1, 128, 128, 6)),
                       ("semantic_raw", (1, 32, 32, 6))):
        assert tuple(a[key].shape) == shape and torch.isfinite(a[key]).all()
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["image_depth"], c["image_depth"])
    with pytest.raises(ValueError, match="torch.Generator"):
        _port_call(Gt, z, mask, pose)            # det=False without a generator
