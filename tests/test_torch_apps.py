"""The port's inference apps (`pix2pix3d_tpu_torch/apps/`, `train/viz.py`,
`utils/marching_cubes.py`) against the JAX package's, on the CPU.

The generator is the small importance-path one of
tests/test_torch_importance_render.py's family (afhq, 128², cbase 1024,
cmax 32, encoder_channel_base 1/128, sr_num_fp16_res 0, 12 + 12 depth
samples, nrr 32), all f32, weights bridged from `G.init(PRNGKey(0))`; the
same numpy z, mask and pose go to both packages (the port draws z from a
`torch.Generator`, so z is always passed).

Tolerances: 1e-4 for the generator's outputs and the sigma grid (the
renderer's gate, tests/test_parity_render.py); uint8 frames within one
level (1e-4-close floats may round to neighbouring levels); orbit poses
1e-6 (f32 trigonometry in two libraries, ~1 ulp); marching cubes,
colorization, vertex labels and configs exactly.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.apps import common as jcommon
from pix2pix3d_tpu.apps import edit as jedit
from pix2pix3d_tpu.apps import extract_mesh as jmesh
from pix2pix3d_tpu.apps import generate_samples as jsamples
from pix2pix3d_tpu.apps import generate_video as jvideo
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.render import camera as jcam
from pix2pix3d_tpu.train import checkpoint as jckpt
from pix2pix3d_tpu.train import viz as jviz
from pix2pix3d_tpu.utils import marching_cubes as jmc

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.apps import common as tcommon
from pix2pix3d_tpu_torch.apps import edit as tedit
from pix2pix3d_tpu_torch.apps import extract_mesh as tmesh
from pix2pix3d_tpu_torch.apps import generate_samples as tsamples
from pix2pix3d_tpu_torch.apps import generate_video as tvideo
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.train import viz as tviz
from pix2pix3d_tpu_torch.utils import marching_cubes as tmc

TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw")
APP = {"neural_rendering_resolution": 32, "focal_length": 4.2647}


def _narrow(cfg, encoder_base=1 / 128):
    cfg["mapping_kwargs"]["encoder_channel_base"] = encoder_base
    cfg["rendering_kwargs"].update(depth_resolution=12,
                                   depth_resolution_importance=12)
    return cfg


def _small_cfg(cfg_mod):
    return _narrow(cfg_mod.generator_config(
        cfg="afhq", resolution=128, data_type="seg", semantic_channels=6,
        cbase=1024, cmax=32, sr_num_fp16_res=0, render_mask=True,
        gen_pose_cond=True))


def _pair(jcfg, tcfg):
    G = jbuild(**jcfg)
    params = jax.device_get(jax.jit(G.init)(jax.random.PRNGKey(0)))
    Gt = tbuild(device="cpu", **tcfg)
    Gt.load_state_dict(bridge.params_from_jax(params), strict=True)
    return G, params, Gt


@pytest.fixture(scope="module")
def generators():
    return _pair(_small_cfg(jconfig), _small_cfg(tconfig))


def _inputs(seed, classes=6, res=128, edge=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, 512).astype(np.float32)
    if edge:
        mask = (rng.rand(res, res, 1) > 0.9).astype(np.float32) * 255
    else:
        mask = rng.randint(0, classes, (res, res, 1)).astype(np.float32)
    c2w = jcam.LookAtPoseSampler.sample(None, np.pi / 2 + 0.2, np.pi / 2 - 0.1,
                                        [0, 0, -0.06], radius=2.7)
    pose = np.array(jcam.pose_to_conditioning(c2w, jcommon.intrinsics_for(
        dict(APP))))[0]
    return z, mask, pose


def _assert_outputs_close(got, want):
    for key in OUTPUTS:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("psi,seed", [(1.0, 0), (0.7, 1)])
def test_generate_sample_matches_jax(generators, psi, seed):
    G, params, Gt = generators
    z, mask, pose = _inputs(seed)
    want = jsamples.generate_sample(G, params, APP, mask, pose, z=jnp.asarray(z),
                                    truncation_psi=psi)
    got = tsamples.generate_sample(Gt, APP, mask, pose, z=z, truncation_psi=psi)
    _assert_outputs_close(got, want)
    with pytest.raises(ValueError, match="expects 128x128"):
        tsamples.generate_sample(Gt, APP, mask[:64, :64], pose, z=z)


def _count_calls(module):
    calls = []
    handle = module.register_forward_hook(lambda *a: calls.append(1))
    return calls, handle


def test_render_video_matches_jax_and_runs_the_backbone_once(generators):
    G, params, Gt = generators
    _, mask, _ = _inputs(2)
    pivot = (0, 0, -0.06)
    cond_pose = np.asarray(jvideo.orbit_poses(APP, 1, 0, 0, pivot=pivot))[0]
    want_frames, want_labels = jvideo.render_video(
        G, params, APP, mask, cond_pose, seed=3, n_frames=3, pivot=pivot)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, G.z_dim)))
    calls, handle = _count_calls(Gt.backbone.synthesis)
    try:
        frames, labels = tvideo.render_video(Gt, APP, mask, cond_pose, z=z,
                                             n_frames=3, pivot=pivot)
    finally:
        handle.remove()
    assert len(calls) == 1
    assert len(frames) == len(labels) == 3
    for got, want in zip(frames, want_frames):
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for got, want in zip(labels, want_labels):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fields(generators):
    """The same ws through both packages' `sigma_field` (16³, blocks of
    1,000 points so that the last block is padded)."""
    G, params, Gt = generators
    z, mask, pose = _inputs(4)
    ws = G.mapping(params, jnp.asarray(z), jnp.asarray(pose)[None],
                   {"mask": jnp.asarray(mask)[None], "pose": jnp.asarray(pose)[None]})
    want, _ = jmesh.sigma_field(G, params, ws, resolution=16, block=1000)
    got, planes = tmesh.sigma_field(Gt, torch.from_numpy(np.asarray(ws)),
                                    resolution=16, block=1000)
    return np.asarray(want), got, ws, planes


def test_sigma_field_matches_jax(fields):
    want, got, _, _ = fields
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def _sphere():
    g = np.linspace(-1, 1, 20)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return 1.0 - np.sqrt(x ** 2 + y ** 2 + z ** 2), 0.5


@pytest.mark.parametrize("case", ["jax_grid", "sphere", "empty"])
def test_marching_cubes_is_identical(fields, case):
    if case == "jax_grid":
        vol = fields[0]
        level = float(np.median(vol))
    elif case == "sphere":
        vol, level = _sphere()
    else:
        vol, level = np.zeros((8, 8, 8), np.float32), 0.5
    verts, faces = tmc.marching_cubes(vol, level)
    want_v, want_f = jmc.marching_cubes(vol, level)
    assert verts.dtype == want_v.dtype and faces.dtype == want_f.dtype
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    if case != "empty":
        assert len(faces) > 50


def test_vertex_labels_match_jax_on_the_jax_mesh(generators, fields):
    """JAX `extract_semantic_mesh` at a threshold inside the field's range;
    the port labels the JAX mesh's vertices as JAX colors them."""
    G, params, Gt = generators
    want_grid, _, ws, planes = fields
    level = float(np.median(want_grid))
    verts, faces, colors = jmesh.extract_semantic_mesh(G, params, ws, resolution=16,
                                                       threshold=level)
    assert len(verts) > 50
    labels = tmesh.vertex_labels(Gt, planes, verts)
    np.testing.assert_array_equal(tviz.color_mask(labels[None])[0], colors)
    got_v, got_f, got_c = tmesh.extract_semantic_mesh(
        Gt, torch.from_numpy(np.asarray(ws)), resolution=16, threshold=level)
    assert got_f.shape[1] == 3 and got_c.shape == (len(got_v), 3)
    assert np.isfinite(got_v).all() and got_c.dtype == np.uint8


def test_save_ply_writes_the_jax_file(tmp_path):
    rng = np.random.RandomState(0)
    verts = rng.randn(5, 3).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]])
    colors = rng.randint(0, 255, (5, 3)).astype(np.uint8)
    for with_colors in (colors, None):
        tmesh.save_ply(str(tmp_path / "t.ply"), verts, faces, with_colors)
        jmesh.save_ply(str(tmp_path / "j.ply"), verts, faces, with_colors)
        assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_edit_session_flow(generators):
    """tests/test_edit_session.py's checks on the port's session, and its
    first frame against JAX's."""
    G, params, Gt = generators
    rng = np.random.RandomState(0)
    mask = rng.randint(0, 6, size=(128, 128)).astype(np.float32)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, G.z_dim)))
    sess = tedit.EditSession(Gt, APP, mask, z=z, radius=2.7, pivot=(0, 0, -0.06))

    img0, sem0, depth0 = sess.render(yaw=0.0)
    assert img0.shape == (128, 128, 3)
    assert sem0.shape == (128, 128, 6)
    assert depth0.shape == (32, 32, 1)
    assert np.isfinite(img0).all()
    jsess = jedit.EditSession(G, params, APP, mask, seed=0, radius=2.7,
                              pivot=(0, 0, -0.06))
    np.testing.assert_allclose(img0, jsess.render(yaw=0.0)[0], **TOL)

    # camera slider: different yaw, same ws and planes (no reconstruct)
    ws_before, planes_before = sess._ws, sess._planes
    img1, _, _ = sess.render(yaw=0.3)
    assert sess._ws is ws_before and sess._planes is planes_before
    assert not np.allclose(img0, img1)

    # brush edit drops ws and the planes; reconstruct changes the render
    sess.paint(slice(30, 60), slice(30, 60), 3)
    assert sess._ws is None and sess._planes is None
    img2, _, _ = sess.render(yaw=0.0)
    assert not np.allclose(img0, img2)
    sess.set_seed(5)
    assert sess._ws is None and sess._planes is None


def test_color_mask_orbit_poses_and_intrinsics_match_jax():
    labels = np.random.RandomState(0).randint(0, 25, (2, 9, 7))
    np.testing.assert_array_equal(tviz.color_mask(labels), jviz.color_mask(labels))
    app = jcommon.APP_PRESETS["seg2cat"]
    assert tcommon.APP_PRESETS == jcommon.APP_PRESETS
    got = tvideo.orbit_poses(app, n_frames=12, pivot=(0, 0, -0.06), device="cpu")
    want = np.asarray(jvideo.orbit_poses(app, n_frames=12, pivot=(0, 0, -0.06)))
    assert tuple(got.shape) == (12, 25)
    # f32 trigonometry in two libraries: equal to ~1 ulp (|pose| <= 2.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcommon.intrinsics_for(app, device="cpu").numpy(),
                                  np.asarray(jcommon.intrinsics_for(app)))
    img = np.linspace(-1.2, 1.2, 24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(tcommon.to_uint8(torch.from_numpy(img)),
                                  jcommon.to_uint8(img))


def test_save_image_grid_writes_the_jax_png(tmp_path):
    images = np.random.RandomState(0).rand(5, 6, 4, 3) * 255
    tviz.save_image_grid(images, str(tmp_path / "t.png"), grid_cols=2)
    jviz.save_image_grid(images, str(tmp_path / "j.png"), grid_cols=2)
    import PIL.Image
    np.testing.assert_array_equal(np.array(PIL.Image.open(tmp_path / "t.png")),
                                  np.array(PIL.Image.open(tmp_path / "j.png")))


def test_generate_samples_cli_on_a_jax_checkpoint(tmp_path, generators):
    """`main --device cpu` on a checkpoint that JAX's `save_checkpoint`
    wrote with its config sidecar: the sidecar's architecture (128²) and
    nrr 64 are used, and the outputs are JAX's for the same z."""
    import PIL.Image
    G, params, _ = generators
    ckpt = str(tmp_path / "small.ckpt")
    jckpt.save_checkpoint(ckpt, {"G_ema": params},
                          config=dict(g_config=_small_cfg(jconfig)), step=0)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 6, (128, 128)).astype(np.uint8)
    png = str(tmp_path / "mask.png")
    PIL.Image.fromarray(labels).save(png)
    outdir = tmp_path / "out"
    tsamples.main(["--network", ckpt, "--cfg", "seg2cat", "--input", png,
                   "--outdir", str(outdir), "--random_seed", "1", "--device", "cpu"])
    color = np.array(PIL.Image.open(outdir / "seg2cat_1_color.png"))
    label = np.array(PIL.Image.open(outdir / "seg2cat_1_label.png"))
    assert color.shape == label.shape == (128, 128, 3)

    Gt, app = tcommon.build_app_generator("seg2cat", checkpoint=ckpt, device="cpu")
    assert app["neural_rendering_resolution"] == 64
    assert Gt.img_resolution == 128 and Gt.data_type == "seg"
    _, japp_params, japp = jcommon.build_app_generator("seg2cat", checkpoint=ckpt)
    assert app == japp
    z = torch.randn((1, 512), generator=torch.Generator().manual_seed(1)).numpy()
    pose = np.array(jsamples_pose(app))
    want = jsamples.generate_sample(G, japp_params, japp, labels[:, :, None], pose,
                                    z=jnp.asarray(z))
    got = tsamples.generate_sample(Gt, app, labels[:, :, None], pose, seed=1)
    _assert_outputs_close(got, want)
    assert np.abs(color.astype(int)
                  - jcommon.to_uint8(want["image"][0]).astype(int)).max() <= 1


def jsamples_pose(app):
    """The JAX app's frontal default pose (`generate_samples.main`)."""
    c2w = jcam.LookAtPoseSampler.sample(None, np.pi / 2, np.pi / 2, [0, 0, 0],
                                        radius=2.7, batch_size=1)
    return np.asarray(jcam.pose_to_conditioning(c2w, jcommon.intrinsics_for(app)))[0]


# --- the released configs --------------------------------------------------

@pytest.mark.parametrize("name", ["seg2cat", "seg2face", "edge2car"])
def test_presets_match_jax(name):
    assert tconfig.PRESETS[name] == jconfig.PRESETS[name]
    assert tconfig.preset_generator_config(name) == jconfig.preset_generator_config(name)


def test_rendering_presets_match_jax():
    assert tconfig.RENDERING_PRESETS == jconfig.RENDERING_PRESETS
    for cfg in jconfig.RENDERING_PRESETS:
        assert (tconfig.rendering_kwargs(cfg, 128)
                == jconfig.rendering_kwargs(cfg, 128))


@pytest.mark.parametrize("name", ["seg2face", "edge2car"])
def test_released_config_forward_matches_jax(name):
    """The preset, narrowed (cbase 1024, cmax 32, sr_num_fp16_res 0, 12 + 12
    depth samples; seg2face at 128² with the 2X SR pair, edge2car at its own
    128²), through both packages' `generate_sample`: seg2face's 19 classes;
    edge2car's raw edge map (rescaled), edge mapping at geometry layer 9,
    white_back and the sigmoid semantic head."""
    over = dict(cbase=1024, cmax=32, sr_num_fp16_res=0, resolution=128)
    G, params, Gt = _pair(_narrow(jconfig.preset_generator_config(name, **over)),
                          _narrow(tconfig.preset_generator_config(name, **over)))
    assert Gt.data_type == G.data_type
    edge = name == "edge2car"
    z, mask, pose = _inputs(5, classes=19, edge=edge)
    if edge:
        assert Gt.rendering_kwargs["white_back"] and Gt.decoder.semantic_sigmoid
        assert type(Gt.backbone.mapping).__name__ == "EdgeMappingNetworkDisentangle"
    want = jsamples.generate_sample(G, params, APP, mask, pose, z=jnp.asarray(z))
    got = tsamples.generate_sample(Gt, APP, mask, pose, z=z)
    _assert_outputs_close(got, want)
    assert got["semantic"].shape[-1] == (1 if edge else 19)


def test_unported_configs_raise(generators):
    """The apps' generator with per-output-tile frustum sub-windows (the
    test keeps the name it had when the port refused them): the port's
    `generate_sample` through the frustum sampler with `frustum_tiles` (f32
    slabs, the unfused decoder) meets JAX's mapping and synthesis (jitted:
    JAX's eager tiles take a minute); tiles too small for the camera
    NaN-poison the render (the guard is held against JAX's in
    tests/test_torch_render.py)."""
    G, params, Gt = generators
    saved = [dict(g.rendering_kwargs) for g in (G, Gt)]
    z, mask, pose = _inputs(0)
    mask_in, pose_in = jnp.asarray(mask)[None], jnp.asarray(pose)[None]
    ws = G.mapping(params, jnp.asarray(z), pose_in, {"mask": mask_in, "pose": pose_in})
    try:
        for tiles, poisoned in (((8, 128, 8, 128, 448), False), ((8, 8, 8, 8, 32), True)):
            for g in (G, Gt):
                g.rendering_kwargs.update(sampler="frustum", frustum_bf16=False,
                                          frustum_tiles=tiles)
            got = tsamples.generate_sample(Gt, APP, mask, pose, z=z)
            if poisoned:
                for key in ("image_raw", "image_depth", "semantic_raw"):
                    assert torch.isnan(got[key]).all(), key
                continue
            want = jax.jit(lambda p, w: G.synthesis(
                p, w, pose_in, neural_rendering_resolution=32, noise_mode="const",
                det=True))(params, ws)
            _assert_outputs_close(got, want)
    finally:
        for g, old in zip((G, Gt), saved):
            g.rendering_kwargs.clear()
            g.rendering_kwargs.update(old)


def _formerly_unported(name):
    """(the config's JAX and port kwargs, the sub-module they changed)."""
    over = dict(cbase=1024, cmax=32, sr_num_fp16_res=0)
    if name == "256":
        cfgs = [_narrow(m.preset_generator_config("seg2face", resolution=256, **over))
                for m in (jconfig, tconfig)]
        return cfgs, "superresolution_semantic"
    preset = "edge2car" if name == "EdgeMappingNetwork" else "seg2cat"
    cfgs = [_narrow(m.preset_generator_config(preset, resolution=128, **over))
            for m in (jconfig, tconfig)]
    for cfg in cfgs:
        cfg["mapping_kwargs"]["class_name"] = name
    return cfgs, "mapping"


@pytest.mark.parametrize("name", ["MaskMappingNetwork", "EdgeMappingNetwork", "256"])
def test_formerly_unported_configs_match_jax(name):
    """The entangled mappings (seg2cat's one-hot masks, edge2car's raw edge
    map) and seg2face at 256² (the 4X SR pair) build in both packages; the
    part each one brought, with JAX's `init` bridged in, meets JAX within
    1e-5 (the module tolerance of tests/test_dual_sr.py): the generator's
    mapping (truncation psi 0.7 toward a nonzero w_avg), or the semantic SR
    stack on a 64² input."""
    (jcfg, tcfg), part = _formerly_unported(name)
    G, Gt = jbuild(**jcfg), tbuild(device="cpu", **tcfg)
    rng = np.random.RandomState(3)
    if part == "mapping":
        tree = jax.device_get(G.backbone.mapping.init(jax.random.PRNGKey(1)))
        tree["w_avg"] = rng.randn(*np.shape(tree["w_avg"])).astype(np.float32)
        Gt.backbone.mapping.load_state_dict(bridge.params_from_jax(tree), strict=True)
        z, mask, pose = _inputs(4, edge=name == "EdgeMappingNetwork")
        mask_in = tcommon.mask_input(Gt, mask, "cpu")
        batch = {"mask": mask_in, "pose": torch.from_numpy(pose)[None]}
        want = G.mapping({"backbone": {"mapping": tree}}, jnp.asarray(z),
                         jnp.asarray(pose[None]),
                         {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                         truncation_psi=0.7)
        got = Gt.mapping(torch.from_numpy(z), batch["pose"], batch,
                         truncation_psi=0.7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        return
    jm = G.superresolution_semantic
    assert type(Gt.superresolution).__name__ == "SuperresolutionHybrid4X"
    tree = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    Gt.superresolution_semantic.load_state_dict(bridge.params_from_jax(tree),
                                                strict=True)
    sem = rng.randn(1, 64, 64, 19).astype(np.float32)
    x = rng.randn(1, 64, 64, 32).astype(np.float32)
    ws = rng.randn(1, 14, 512).astype(np.float32)
    want = jm(tree, jnp.asarray(sem), jnp.asarray(x), jnp.asarray(ws), noise_mode="const")
    got = Gt.superresolution_semantic(
        torch.from_numpy(sem).permute(0, 3, 1, 2), torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(ws), noise_mode="const")
    assert tuple(got.shape) == (1, 19, 256, 256)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
