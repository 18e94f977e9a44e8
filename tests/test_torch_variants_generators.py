"""Every generator the JAX registry builds besides the shipped one, the
port's against the JAX package's, on the CPU: `TriPlaneGenerator`
(train.py's defaults), `TriPlaneSemanticEntangleGenerator_withBG`
(`--use_bg True`), `TriPlaneSemanticGenerator` (two backbones) and the
shipped generator at 256² (the 4X SR pair) with `dual_sr`.

Each runs the small configuration (afhq, cbase 512, cmax 16, encoder
channel base 1/128, 8 + 8 depth samples, nrr 16, sr_num_fp16_res 0, f32).
The weights are the port's init (`torch.Generator().manual_seed(0)`,
every `noise_strength` at 0.1) as the JAX tree (`bridge.params_to_jax`),
checked key for key and shape for shape against
`jax.eval_shape(G.init, key)`: the JAX `init` itself compiles for ~20 s a
generator, and tests/test_torch_variants.py loads JAX `init`s into every
new module (the checkpoint tests carry the trees both ways).  Const noise,
`det=True`; z, mask and camera from numpy seeds.  Each sampler the class
has: the importance renderer, and the frustum renderer (8 slabs in one
chunk, f32 slabs); the background generator also through the fused
decode+composite (the port's kernel wrapper, its plain version on the CPU,
against the unfused render: the JAX side's Pallas interpreter would add
~20 s, and tests/test_torch_generator_options.py holds the port's fused
path to it).

Tolerance: rtol 1e-4 and atol 1e-4 times the output's largest magnitude
(at least 1), as tests/test_torch_apps.py holds the shipped generator's
outputs, which lie within about [-1, 1] (f32 on both sides; the backbone's
and SR stacks' summation orders differ).  The scale matters for the
background generator's semantic output: the background's class-0 logit is
20 by design, its SR output reaches ~20, and the SR stack's rounding
grows with its inputs' magnitude, not with each output's (up to 1.6e-4
apart from JAX's, 8e-6 of the scale).  The dual SR pass against the
separate one: 1e-5 (tests/test_dual_sr.py).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.models import triplane as jtriplane
from pix2pix3d_tpu.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                         pose_to_conditioning)

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.models import triplane as ttriplane
from pix2pix3d_tpu_torch.ops import decode_composite as tdc
from pix2pix3d_tpu_torch.ops import late_separate_decode as tlsd
from pix2pix3d_tpu_torch.utils.misc import tree_paths

from test_torch_train_phases import two_torch_threads
from test_torch_variants import _noisy

__all__ = ["two_torch_threads"]

TOL = 1e-4
NRR = 16
FRUSTUM = dict(sampler="frustum", frustum_depth_steps=8, frustum_chunk=8,
               frustum_bf16=False)


def small_cfg(cfg_mod, class_name=None, preset=None, **kw):
    """The small configuration of a training config (`generator_config`'s
    kwargs) or of a preset narrowed to it."""
    kw = dict(dict(resolution=128, cbase=512, cmax=16, sr_num_fp16_res=0), **kw)
    if preset is None:
        cfg = cfg_mod.generator_config(cfg="afhq", data_type="seg",
                                       semantic_channels=6, gen_pose_cond=True, **kw)
    else:
        cfg = cfg_mod.preset_generator_config(preset, **kw)
    if class_name is not None:
        cfg["class_name"] = class_name
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    cfg["rendering_kwargs"].update(depth_resolution=8, depth_resolution_importance=8)
    return cfg


def assert_same_tree(got, want):
    """Equal nested keys, and leaves of equal shapes."""
    got, want = dict(tree_paths(got)), dict(tree_paths(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, w in want.items():
        assert tuple(np.shape(got[k])) == tuple(w.shape), k


def pair(**kw):
    """(JAX generator, the port's weights as the JAX tree, the port's
    generator)."""
    G = jbuild(**small_cfg(jconfig, **kw))
    Gt = tbuild(device="cpu", **small_cfg(tconfig, **kw))
    params = bridge.params_to_jax(Gt)
    assert_same_tree(params, jax.eval_shape(G.init, jax.random.PRNGKey(0)))
    params = _noisy(params)
    Gt.load_state_dict(bridge.params_from_jax(params), strict=True)
    return G, params, Gt


def request(seed, res, classes=6, yaw=0.3):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, 512).astype(np.float32)
    mask = rng.randint(0, classes, (1, res, res, 1)).astype(np.float32)
    c2w = LookAtPoseSampler.sample(None, np.pi / 2 + yaw, np.pi / 2 - 0.1,
                                   [0, 0, -0.06], radius=2.7, batch_size=1)
    pose = np.asarray(pose_to_conditioning(c2w, fov_to_intrinsics(18.837)))
    return z, mask, pose


def run_jax(G, params, req):
    z, mask, pose = req
    fn = jax.jit(lambda p, z, m, c: G(p, z, c, {"mask": m, "pose": c},
                                      neural_rendering_resolution=NRR,
                                      noise_mode="const", det=True))
    return {k: np.asarray(v) for k, v in fn(params, z, mask, pose).items()}


def run_port(Gt, req, **kw):
    z, mask, pose = (torch.from_numpy(a) for a in req)
    with torch.no_grad():
        out = Gt(z, pose, {"mask": mask, "pose": pose}, neural_rendering_resolution=NRR,
                 noise_mode="const", det=True, **kw)
    return {k: v.numpy() for k, v in out.items()}


def assert_outputs_close(got, want, keys):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in keys:
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        assert np.isfinite(got[k]).all(), k
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL * scale,
                                   err_msg=k)


def _with_keys(G, Gt, keys):
    """Context: both generators' rendering_kwargs updated with `keys`."""
    class _Ctx:
        def __enter__(self):
            self.saved = dict(G.rendering_kwargs), dict(Gt.rendering_kwargs)
            for rk in (G.rendering_kwargs, Gt.rendering_kwargs):
                rk.update(keys)

        def __exit__(self, *exc):
            for live, old in zip((G.rendering_kwargs, Gt.rendering_kwargs), self.saved):
                live.clear()
                live.update(old)
    return _Ctx()


# --- TriPlaneGenerator: conditional EG3D, train.py's defaults -------------------

@pytest.fixture(scope="module")
def eg3d():
    return pair(render_mask=False)


@pytest.mark.parametrize("sampler_keys", [{}, FRUSTUM], ids=["importance", "frustum"])
def test_triplane_generator_matches_jax(eg3d, sampler_keys):
    """The OSGDecoder's 32 feature channels through both samplers, one SR
    stack; no semantic outputs."""
    G, params, Gt = eg3d
    assert type(Gt).__name__ == "TriPlaneGenerator" and Gt.data_type == "seg"
    req = request(0, 128)
    with _with_keys(G, Gt, sampler_keys):
        want, got = run_jax(G, params, req), run_port(Gt, req)
    assert_outputs_close(got, want, ("image", "image_raw", "image_depth", "planes"))
    assert got["image"].shape == (1, 128, 128, 3)


def test_triplane_generator_reuses_cached_planes(eg3d):
    """`synthesis(planes=...)` (the cross-view renders' cache) gives the
    forward's outputs."""
    _, _, Gt = eg3d
    req = request(1, 128)
    full = run_port(Gt, req)
    z, mask, pose = (torch.from_numpy(a) for a in req)
    with torch.no_grad():
        ws = Gt.mapping(z, pose, {"mask": mask, "pose": pose})
        out = Gt.synthesis(ws, pose, neural_rendering_resolution=NRR,
                           noise_mode="const", det=True,
                           planes=torch.from_numpy(full["planes"]))
    for k in ("image", "image_raw", "image_depth"):
        np.testing.assert_array_equal(out[k].numpy(), full[k], err_msg=k)


# --- the background-plane generator (--use_bg True) -----------------------------

@pytest.fixture(scope="module")
def with_bg():
    return pair(render_mask=True, use_bg=True)


BG_OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw",
              "weight", "planes")


@pytest.mark.parametrize("keys", [{}, FRUSTUM], ids=["importance", "frustum"])
def test_background_generator_matches_jax(with_bg, keys):
    """Both samplers; the `weight` image and the background composited
    where the weight is below 1.  On the frustum sampler also the fused
    decode+composite (`decoder_impl="kernel"`: one call of the kernel's
    wrapper, its plain version on the CPU) against the unfused render,
    within the JAX suite's fused-vs-unfused generator tolerance, 5e-3
    (tests/test_render_pallas.py::test_generator_fused_frustum_path)."""
    G, params, Gt = with_bg
    req = request(2, 128, yaw=0.6)
    calls = []
    wrapped = tdc.fused_decode_composite

    def spy(*a, **kw):
        calls.append(1)
        return wrapped(*a, **kw)

    with _with_keys(G, Gt, keys):
        want, got = run_jax(G, params, req), run_port(Gt, req)
        if keys:
            Gt.rendering_kwargs["decoder_impl"] = "kernel"
            tdc.fused_decode_composite = spy
            try:
                fused = run_port(Gt, req)
            finally:
                tdc.fused_decode_composite = wrapped
    assert_outputs_close(got, want, BG_OUTPUTS)
    w = got["weight"]
    assert w.shape == (1, NRR, NRR, 1) and (w >= 0).all() and (w <= 1 + 1e-5).all()
    assert w.min() < 0.99   # some background shows
    if keys:
        assert len(calls) == 1
        for k in BG_OUTPUTS:
            np.testing.assert_allclose(fused[k], got[k], rtol=5e-3, atol=5e-3,
                                       err_msg=k)


def test_background_generator_importance_kernel_decoder(with_bg):
    """The importance render of the background generator's planes through
    `G.decoder(f, d, impl="kernel")` (the lateSeparate kernel's wrapper; its
    plain version here) against impl="ref"."""
    _, _, Gt = with_bg
    from pix2pix3d_tpu_torch.render.ray_sampler import sample_rays
    out = run_port(Gt, request(3, 128))
    _, _, pose = request(3, 128)
    pose = torch.from_numpy(pose)
    ro, rd = sample_rays(pose[:, :16].reshape(-1, 4, 4), pose[:, 16:].reshape(-1, 3, 3),
                         NRR)
    planes = torch.from_numpy(out["planes"])
    calls = []
    wrapped = tlsd.late_separate_decode

    def spy(*a, **kw):
        calls.append(1)
        return wrapped(*a, **kw)

    def render(impl):
        return Gt.renderer(planes, lambda f, d: Gt.decoder(f, d, impl=impl), ro, rd,
                           Gt.rendering_kwargs, det=True)

    with torch.no_grad():
        tlsd.late_separate_decode = spy
        try:
            got = render("kernel")
        finally:
            tlsd.late_separate_decode = wrapped
        want = render("ref")
    assert len(calls) == 2   # the coarse and the fine pass
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


# --- two backbones ----------------------------------------------------------------

@pytest.fixture(scope="module")
def two_backbones():
    return pair(render_mask=True, class_name="TriPlaneSemanticGenerator")


def test_two_backbone_generator_matches_jax(two_backbones):
    """Texture and semantic planes from their own backbones; ws `[N, num_ws,
    2 * w_dim]`; the importance sampler (its only one)."""
    G, params, Gt = two_backbones
    req = request(4, 128)
    z, mask, pose = (torch.from_numpy(a) for a in req)
    with torch.no_grad():
        ws = Gt.mapping(z, pose, {"mask": mask, "pose": pose})
    assert tuple(ws.shape) == (1, Gt.backbone.num_ws, 1024)
    want, got = run_jax(G, params, req), run_port(Gt, req)
    assert_outputs_close(got, want, ("image", "image_raw", "image_depth", "semantic",
                                     "semantic_raw"))
    with pytest.raises(NotImplementedError, match="sample_mixed"):
        Gt.sample_mixed(None, None, ws)


# --- 256², the 4X SR pair, dual SR -------------------------------------------------

@pytest.fixture(scope="module")
def res256():
    return pair(preset="seg2face", resolution=256)


def _count_dual(monkeypatch, module):
    calls = []
    wrapped = module.dual_superresolution

    def spy(*a, **kw):
        calls.append(1)
        return wrapped(*a, **kw)
    monkeypatch.setattr(module, "dual_superresolution", spy)
    return calls


def test_256_generator_with_dual_sr_matches_jax(res256, monkeypatch):
    """seg2face's 19 classes at 256² through the 4X pair, as one grouped
    pass (`rendering_kwargs['dual_sr']`) in both packages, and against the
    port's separate stacks."""
    G, params, Gt = res256
    assert type(Gt.superresolution).__name__ == "SuperresolutionHybrid4X"
    req = request(5, 256, classes=19)
    separate = run_port(Gt, req)
    jcalls = _count_dual(monkeypatch, jtriplane)
    tcalls = _count_dual(monkeypatch, ttriplane)
    with _with_keys(G, Gt, {"dual_sr": True}):
        want, got = run_jax(G, params, req), run_port(Gt, req)
    assert (len(jcalls), len(tcalls)) == (1, 1)
    assert_outputs_close(got, want, ("image", "image_raw", "image_depth", "semantic",
                                     "semantic_raw", "planes"))
    assert got["semantic"].shape == (1, 256, 256, 19)
    for k in ("image", "semantic"):
        np.testing.assert_allclose(got[k], separate[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("keys", [{"sr_sem_precision": "highest"}, {"sr_sem_f32": True}])
def test_semantic_precision_takes_priority_over_dual_sr(res256, monkeypatch, keys):
    """As in JAX: the semantic stack at its own precision runs the two
    stacks separately, whatever `dual_sr` says."""
    _, _, Gt = res256
    calls = _count_dual(monkeypatch, ttriplane)
    rk = Gt.rendering_kwargs
    saved = dict(rk)
    rk.update(dual_sr=True, **keys)
    try:
        run_port(Gt, request(6, 256, classes=19))
    finally:
        rk.clear()
        rk.update(saved)
    assert calls == []


def test_new_generators_default_to_the_card():
    for kw in (dict(render_mask=False), dict(use_bg=True),
               dict(class_name="TriPlaneSemanticGenerator")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbuild(**small_cfg(tconfig, **kw))
