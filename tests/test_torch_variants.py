"""The port's variant modules against the JAX package's, on the CPU: the
registries, the training configs that select the variants, the SR classes
of the 256² and 8X configurations, `dual_superresolution`, the entangled
mappings and the OSG decoders.

Weights: each JAX module's `init(PRNGKey)`, every `noise_strength` set to
0.1 (0 at init, which would hide the noise), through
`bridge.params_from_jax` into the port's module.  Inputs: numpy draws from
a seed, NHWC into JAX, NCHW into the port.

Tolerance: 1e-5 (rtol and atol) for every module output, as
tests/test_dual_sr.py holds the dual pass to the separate calls: f32 on
both sides, only the summation order differs.  bf16 blocks (the dual pass
at `sr_num_fp16_res` > 0): 2e-2, that file's bf16 gate.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import triplane as jtriplane
from pix2pix3d_tpu.nn import cond_mapping as jmapping
from pix2pix3d_tpu.nn import superresolution as jsr

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import triplane as ttriplane
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.nn import cond_mapping as tmapping
from pix2pix3d_tpu_torch.nn import superresolution as tsr

from test_torch_train_phases import two_torch_threads

__all__ = ["two_torch_threads"]

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _noisy(tree):
    """The tree with every `noise_strength` leaf at 0.1 (numpy)."""
    return {k: (_noisy(v) if isinstance(v, dict) else
                np.full_like(v, 0.1) if k == "noise_strength" else np.asarray(v))
            for k, v in tree.items()}


def _port(module, tree):
    module.load_state_dict(bridge.params_from_jax(tree), strict=True)
    return module.eval().requires_grad_(False)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got_nchw, want_nhwc, tol=TOL, what=""):
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_nhwc), err_msg=what, **tol)


# --- registries and configs --------------------------------------------------

@pytest.mark.parametrize("registry", ["GENERATOR", "MAPPING", "SR"])
def test_registries_hold_every_jax_key(registry):
    want, got = {
        "GENERATOR": (jtriplane.GENERATOR_REGISTRY, ttriplane.GENERATOR_REGISTRY),
        "MAPPING": (jtriplane.MAPPING_REGISTRY, ttriplane.MAPPING_REGISTRY),
        "SR": (jsr._SR_REGISTRY, tsr._SR_REGISTRY)}[registry]
    assert set(got) == set(want)
    for name, cls in want.items():
        assert got[name].__name__ == cls.__name__


CONFIGS = {
    "train_py_defaults": dict(render_mask=False),
    "use_bg": dict(render_mask=True, use_bg=True),
    "res256": dict(resolution=256),
    "edge_defaults": dict(render_mask=False, data_type="edge", semantic_channels=1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_config_equals_jax(name):
    kw = dict(cfg="afhq", data_type="seg", semantic_channels=6, gen_pose_cond=True)
    kw.update(CONFIGS[name])
    assert "dual_sr" not in tconfig.generator_config(**kw)["rendering_kwargs"]
    want, got = jconfig.generator_config(**kw), tconfig.generator_config(**kw)
    assert got == want
    res = kw.get("resolution", 512)
    assert tconfig.rendering_kwargs("afhq", res) == jconfig.rendering_kwargs("afhq", res)
    assert (tconfig.preset_generator_config("seg2face", resolution=res)
            == jconfig.preset_generator_config("seg2face", resolution=res))


def test_train_py_defaults_select_the_jax_classes():
    for kw, cls in ((dict(render_mask=False), "TriPlaneGenerator"),
                    (dict(render_mask=True, use_bg=True),
                     "TriPlaneSemanticEntangleGenerator_withBG")):
        assert tconfig.generator_config(**kw)["class_name"] == cls
    rk = tconfig.rendering_kwargs("celeba", 256)
    assert (rk["superresolution_module"], rk["superresolution_module_semantic"]) == \
        ("SuperresolutionHybrid4X", "SuperresolutionHybrid4X_semantic")


# --- SR classes ---------------------------------------------------------------

SR_CASES = {
    # name: (output resolution, semantic channels or None)
    "SuperresolutionHybrid8X": (512, None),
    "SuperresolutionHybrid4X": (256, None),
    "SuperresolutionHybrid4X_semantic": (256, 5),
    "SuperresolutionHybridDeepfp32": (256, None),
}


def _sr_pair(name, res, sem, seed=0, fp16=0):
    kw = dict(channels=32, img_resolution=res, sr_num_fp16_res=fp16,
              sr_antialias=True)
    if sem is not None:
        kw["semantic_channels"] = sem
    jm = jsr.build_superresolution(name, **kw)
    tree = _noisy(jax.device_get(jm.init(jax.random.PRNGKey(seed))))
    return jm, tree, _port(tsr.build_superresolution(name, **kw), tree)


def _sr_inputs(seed, img_ch, res_in=64, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, res_in, res_in, img_ch).astype(np.float32),
            rng.randn(b, res_in, res_in, 32).astype(np.float32),
            rng.randn(b, 14, 512).astype(np.float32))


@pytest.mark.parametrize("name", sorted(SR_CASES))
def test_sr_module_matches_jax(name):
    """Const noise (the layers' stored noise at strength 0.1); 64² inputs,
    resized to the stack's 128² (4X's `resize_condition="lt"`)."""
    res, sem = SR_CASES[name]
    jm, tree, tm = _sr_pair(name, res, sem)
    assert tm.resize_condition == jm.resize_condition
    assert tm.sr_antialias == jm.sr_antialias == (name != "SuperresolutionHybridDeepfp32")
    rgb, x, ws = _sr_inputs(1, sem or 3)
    want = jax.jit(lambda p, a, b, c: jm(p, a, b, c, noise_mode="const"))(
        tree, rgb, x, ws)
    with torch.no_grad():
        got = tm(_nchw(rgb), _nchw(x), torch.from_numpy(ws), noise_mode="const")
    assert tuple(got.shape) == (2, sem or 3, res, res)
    _close(got, want, what=name)


def test_sr_4x_keeps_inputs_at_or_above_128():
    """`resize_condition="lt"`: a 128² input passes as it is, a 64² one is
    resized (the 2X and 8X stacks resize whatever differs)."""
    _, _, tm = _sr_pair("SuperresolutionHybrid4X", 256, None)
    x = torch.randn(1, 32, 128, 128)
    assert tm.resize(x) is x
    assert tuple(tm.resize(torch.randn(1, 32, 64, 64)).shape) == (1, 32, 128, 128)


def test_sr_wrong_resolution_raises():
    with pytest.raises(ValueError, match="256"):
        tsr.build_superresolution("SuperresolutionHybrid4X", channels=32,
                                  img_resolution=512, sr_num_fp16_res=0,
                                  sr_antialias=True)


# --- dual SR -----------------------------------------------------------------

def _dual_setup(sem_ch, fp16=0):
    kw = dict(channels=32, img_resolution=128, sr_num_fp16_res=fp16,
              sr_antialias=True)
    jr = jsr.SuperresolutionHybrid2X(**kw)
    js = jsr.SuperresolutionHybrid2XSemantic(semantic_channels=sem_ch, **kw)
    p_rgb = _noisy(jax.device_get(jr.init(jax.random.PRNGKey(0))))
    p_sem = _noisy(jax.device_get(js.init(jax.random.PRNGKey(1))))
    tr = _port(tsr.SuperresolutionHybrid2X(**kw), p_rgb)
    ts = _port(tsr.SuperresolutionHybrid2XSemantic(semantic_channels=sem_ch, **kw),
               p_sem)
    rng = np.random.RandomState(2)
    arrays = [rng.randn(2, 64, 64, c).astype(np.float32) for c in (3, 32, sem_ch, 32)]
    ws = rng.randn(2, 14, 512).astype(np.float32)
    return (jr, js, p_rgb, p_sem), (tr, ts), arrays, ws


@pytest.mark.parametrize("sem_ch,noise_mode",
                         [(6, "none"), (6, "const"), (1, "const"), (6, "random")])
def test_dual_superresolution_matches_separate_and_jax(sem_ch, noise_mode):
    """The grouped pass against the port's two separate calls (with
    "random", both ways from equally seeded generators: the dual pass draws
    the separate calls' numbers) and against JAX's vmapped pass (fixed
    noise only: the frameworks draw different numbers).  sem_ch 1 pads the
    semantic stack's ToRGB up to rgb's 3 channels, 6 rgb's up to 6."""
    (jr, js, p_rgb, p_sem), (tr, ts), arrays, ws = _dual_setup(sem_ch)
    assert tsr.dual_sr_compatible(tr, ts) and jsr.dual_sr_compatible(jr, js)
    rgb, x_rgb, sem, x_sem = (_nchw(a) for a in arrays)
    tws = torch.from_numpy(ws)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    with torch.no_grad():
        sep_rgb = tr(rgb, x_rgb, tws, noise_mode=noise_mode, generator=gens[0])
        sep_sem = ts(sem, x_sem, tws, noise_mode=noise_mode, generator=gens[0])
        dual_rgb, dual_sem = tsr.dual_superresolution(
            tr, ts, rgb, x_rgb, sem, x_sem, tws, noise_mode=noise_mode,
            generator=gens[1])
    assert tuple(dual_rgb.shape) == (2, 3, 128, 128)
    assert tuple(dual_sem.shape) == (2, sem_ch, 128, 128)
    np.testing.assert_allclose(dual_rgb.numpy(), sep_rgb.numpy(), **TOL)
    np.testing.assert_allclose(dual_sem.numpy(), sep_sem.numpy(), **TOL)
    if noise_mode == "random":
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        return
    want_rgb, want_sem = jax.jit(lambda a, b, c, d, e, f, w: jsr.dual_superresolution(
        jr, js, a, b, c, d, e, f, w, noise_mode=noise_mode))(
        p_rgb, p_sem, *arrays, ws)
    _close(dual_rgb, want_rgb, what="rgb")
    _close(dual_sem, want_sem, what="semantic")


def test_dual_superresolution_bf16_blocks():
    """sr_num_fp16_res > 0 (the serving config): the grouped bf16 pass
    against the separate bf16 calls."""
    _, (tr, ts), arrays, ws = _dual_setup(6, fp16=4)
    args = [_nchw(a) for a in arrays]
    with torch.no_grad():
        want = (tr(args[0], args[1], torch.from_numpy(ws), noise_mode="const"),
                ts(args[2], args[3], torch.from_numpy(ws), noise_mode="const"))
        got = tsr.dual_superresolution(tr, ts, *args, torch.from_numpy(ws),
                                       noise_mode="const")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BF16_TOL)


def test_dual_sr_compatible_refuses_other_topologies():
    kw = dict(channels=32, sr_num_fp16_res=0, sr_antialias=True)
    a = tsr.SuperresolutionHybrid2X(img_resolution=128, **kw)
    assert not tsr.dual_sr_compatible(
        a, tsr.SuperresolutionHybrid4XSemantic(img_resolution=256,
                                               semantic_channels=6, **kw))
    assert not tsr.dual_sr_compatible(
        a, tsr.SuperresolutionHybrid2XSemantic(img_resolution=128,
                                               semantic_channels=6,
                                               channels=32, sr_num_fp16_res=4,
                                               sr_antialias=True))


# --- entangled mappings --------------------------------------------------------

@pytest.mark.parametrize("name,psi", [("MaskMappingNetwork", 1.0),
                                      ("MaskMappingNetwork", 0.7),
                                      ("EdgeMappingNetwork", 0.7)])
def test_entangled_mapping_matches_jax(name, psi):
    """The encoder's W (output_mode "W") joins z and the embedded c before
    the FC stack; truncation toward a nonzero `[w_dim]` w_avg."""
    edge = name == "EdgeMappingNetwork"
    kw = dict(z_dim=512, c_dim=25, in_resolution=64, in_channels=1 if edge else 6,
              w_dim=512, num_ws=14, num_layers=2, encoder_channel_base=1 / 64)
    jm = getattr(jmapping, name)(**kw)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)
    tree["w_avg"] = rng.randn(512).astype(np.float32)
    tm = _port(getattr(tmapping, name)(**kw), tree)
    assert tuple(tm.w_avg.shape) == (512,)
    z = rng.randn(2, 512).astype(np.float32)
    c = rng.randn(2, 25).astype(np.float32)
    mask = (rng.rand(2, 64, 64, 1).astype(np.float32) * 2 - 1 if edge
            else rng.randint(0, 6, (2, 64, 64, 1)).astype(np.float32))
    want = jax.jit(lambda p, z, c, m: jm(p, z=z, c=c, batch={"mask": m},
                                         truncation_psi=psi))(tree, z, c, mask)
    with torch.no_grad():
        got = tm(z=torch.from_numpy(z), c=torch.from_numpy(c),
                 batch={"mask": torch.from_numpy(mask)}, truncation_psi=psi)
    assert tuple(got.shape) == (2, 14, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- decoders ------------------------------------------------------------------

DECODERS = [("OSGDecoder", 32, {}),
            ("OSGDecoderSemantic", 32, {"sigmoid": True}),
            ("OSGDecoderSemantic", 32, {"sigmoid": False}),
            ("OSGDecoderSemanticEntangle", 32, {"sigmoid": True, "semantic_channels": 6}),
            ("OSGDecoderSemanticEntangle", 32, {"sigmoid": False, "semantic_channels": 6}),
            ("OSGDecoder", 64, {})]


@pytest.mark.parametrize("name,n_features,extra", DECODERS)
def test_decoder_matches_jax(name, n_features, extra):
    opts = dict(decoder_lr_mul=1.0, decoder_output_dim=32, **extra)
    jd = getattr(jtriplane, name)(n_features, opts)
    tree = jax.device_get(jd.init(jax.random.PRNGKey(6)))
    rng = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.randn(*a.shape)
                                  .astype(np.float32), tree)   # nonzero biases
    td = _port(getattr(ttriplane, name)(n_features, opts), tree)
    feats = rng.randn(2, 3, 500, n_features).astype(np.float32)
    dirs = rng.randn(2, 500, 3).astype(np.float32)
    want = jd(tree, jnp.asarray(feats), jnp.asarray(dirs))
    with torch.no_grad():
        got = td(torch.from_numpy(feats), torch.from_numpy(dirs))
    for k in ("rgb", "sigma"):
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


# --- the fused decoder needs the lateSeparate topology --------------------------

@pytest.mark.parametrize("impl", ["kernel", "pallas"])
def test_triplane_generator_refuses_the_fused_decoder(impl):
    """As the JAX package (`models/triplane.py:231-243`): the fused
    decode+composite kernel hard-codes the lateSeparate decoder, so
    `TriPlaneGenerator`'s OSGDecoder refuses decoder_impl on the frustum
    sampler; the JAX package raises the same error for "pallas"."""
    cfg = tconfig.generator_config(resolution=128, cbase=512, cmax=16,
                                   sr_num_fp16_res=0, render_mask=False)
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    cfg["rendering_kwargs"].update(sampler="frustum", decoder_impl=impl,
                                   frustum_depth_steps=8, frustum_chunk=4)
    G = tbuild(device="cpu", **cfg)
    assert type(G.decoder).__name__ == "OSGDecoder"
    planes = torch.zeros(1, 3, 16, 16, 32)
    pose = torch.eye(4).reshape(1, 16)
    c = torch.cat([pose, torch.tensor([[1.0, 0, 0.5, 0, 1, 0.5, 0, 0, 1]])], 1)
    with pytest.raises(ValueError, match="OSGDecoderSemanticLateSeparate"):
        G.synthesis(None, c, neural_rendering_resolution=16, planes=planes)
    jG = jtriplane.build_generator(**dict(cfg, rendering_kwargs=dict(
        cfg["rendering_kwargs"], decoder_impl="pallas")))
    with pytest.raises(ValueError, match="OSGDecoderSemanticLateSeparate"):
        jG._render_planes({}, jnp.zeros((1, 3, 16, 16, 32)), jnp.asarray(c.numpy()), 16)
