"""The port's layers and networks (`pix2pix3d_tpu_torch/nn`) against the JAX
package's, with parameters bridged from one JAX param tree
(`bridge.params_from_jax(jax.device_get(M.init(key)))`).

All f32 on the CPU at narrow widths.  Tolerance 1e-4 (rtol and atol): both
sides are f32 convolutions/matmuls (JAX at Precision.HIGHEST) summing in
different orders through several layers; the JAX suite holds its own
modulated conv and synthesis layers to the reference at 1e-4..1e-3
(tests/test_parity_torch.py).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn import cond_mapping as jcond
from pix2pix3d_tpu.nn import discriminator as jdisc
from pix2pix3d_tpu.nn import encoder as jenc
from pix2pix3d_tpu.nn import layers as jlayers
from pix2pix3d_tpu.nn import mapping as jmap
from pix2pix3d_tpu.nn import superresolution as jsr
from pix2pix3d_tpu.nn import synthesis as jsyn

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.nn import cond_mapping as tcond
from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.nn import encoder as tenc
from pix2pix3d_tpu_torch.nn import layers as tlayers
from pix2pix3d_tpu_torch.nn import mapping as tmap
from pix2pix3d_tpu_torch.nn import superresolution as tsr
from pix2pix3d_tpu_torch.nn import synthesis as tsyn
from pix2pix3d_tpu_torch.ops.upfirdn2d import setup_filter

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def bridged(jmod, tmod, seed=0):
    """JAX params of `jmod` and `tmod` loaded with the same values."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed))
    tmod.load_state_dict(bridge.params_from_jax(jax.device_get(params)),
                         strict=True)
    return params, tmod.eval()


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def from_nhwc(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_normalize_2nd_moment():
    x = np.random.RandomState(0).randn(3, 17).astype(np.float32)
    np.testing.assert_allclose(tlayers.normalize_2nd_moment(t(x)).numpy(),
                               np.asarray(jlayers.normalize_2nd_moment(x)), **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(activation="lrelu", lr_multiplier=0.01),
                                dict(bias_init=1.0, bias=True)])
def test_fully_connected(kw):
    jm, tm = jlayers.FullyConnected(24, 10, **kw), tlayers.FullyConnected(24, 10, **kw)
    params, tm = bridged(jm, tm)
    x = np.random.RandomState(1).randn(5, 24).astype(np.float32)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(),
                               np.asarray(jm(params, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("kw,gain", [
    (dict(kernel_size=3, activation="lrelu"), 1.0),
    (dict(kernel_size=3, activation="lrelu", down=2, conv_clamp=256), np.sqrt(0.5)),
    (dict(kernel_size=1, bias=False, down=2), np.sqrt(0.5)),
])
def test_conv2d_layer(kw, gain):
    jm, tm = jlayers.Conv2d(4, 6, **kw), tlayers.Conv2d(4, 6, **kw)
    params, tm = bridged(jm, tm)
    x = np.random.RandomState(2).randn(2, 4, 16, 16).astype(np.float32)
    np.testing.assert_allclose(tm(t(x), gain=gain).detach().numpy(),
                               from_nhwc(jm(params, nhwc(x), gain=gain)), **TOL)


def test_equal_conv2d():
    jm = jlayers.EqualConv2d(8, 12, 4, padding=0, bias=True)
    tm = tlayers.EqualConv2d(8, 12, 4, padding=0, bias=True)
    params = jm.init(jax.random.PRNGKey(3))
    params = {"weight": params["weight"],
              "bias": jnp.linspace(-1, 1, 12, dtype=jnp.float32)}
    tm.load_state_dict(bridge.params_from_jax(jax.device_get(params)))
    x = np.random.RandomState(3).randn(2, 8, 4, 4).astype(np.float32)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(),
                               from_nhwc(jm(params, nhwc(x))), **TOL)


@pytest.mark.parametrize("demodulate,up,noise", [(True, 1, True), (True, 2, False),
                                                 (False, 1, False)])
def test_modulated_conv2d(demodulate, up, noise):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 8, 8).astype(np.float32)
    w = rng.randn(3, 3, 5, 7).astype(np.float32)                 # HWIO
    s = rng.randn(2, 5).astype(np.float32)
    res = 8 * up
    nz = rng.randn(1, res, res, 1).astype(np.float32) if noise else None
    want = from_nhwc(jlayers.modulated_conv2d(
        nhwc(x), jnp.asarray(w), jnp.asarray(s),
        noise=None if nz is None else jnp.asarray(nz), up=up, padding=1,
        resample_filter=jax.numpy.asarray(np.asarray(setup_filter([1, 3, 3, 1]))),
        demodulate=demodulate, flip_weight=up == 1))
    got = tlayers.modulated_conv2d(
        t(x), t(w.transpose(3, 2, 0, 1)), t(s),
        noise=None if nz is None else t(nz.transpose(0, 3, 1, 2)), up=up,
        padding=1, resample_filter=setup_filter([1, 3, 3, 1]),
        demodulate=demodulate, flip_weight=up == 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.7, 2)])
def test_mapping_network(psi, cutoff):
    kw = dict(z_dim=16, c_dim=25, w_dim=32, num_ws=4, num_layers=2)
    jm, tm = jmap.MappingNetwork(**kw), tmap.MappingNetwork(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5))
    params["w_avg"] = jnp.linspace(-0.5, 0.5, 32, dtype=jnp.float32)
    tm.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    rng = np.random.RandomState(5)
    z = rng.randn(3, 16).astype(np.float32)
    c = rng.randn(3, 25).astype(np.float32)
    want = jm(params, jnp.asarray(z), jnp.asarray(c), truncation_psi=psi,
              truncation_cutoff=cutoff)
    got = tm(t(z), t(c), truncation_psi=psi, truncation_cutoff=cutoff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("in_channels", [0, 8])
def test_discriminator_block(in_channels):
    kw = dict(in_channels=in_channels, tmp_channels=8, out_channels=12,
              img_channels=6)
    jm = jdisc.DiscriminatorBlock(resolution=16, first_layer_idx=0, **kw)
    tm = tdisc.DiscriminatorBlock(**kw)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(6)
    img = rng.randn(2, 6, 16, 16).astype(np.float32)
    x = rng.randn(2, 8, 16, 16).astype(np.float32) if in_channels else None
    wx, _ = jm(params, None if x is None else nhwc(x), nhwc(img))
    gx, _ = tm(None if x is None else t(x), t(img))
    np.testing.assert_allclose(gx.numpy(), from_nhwc(wx), **TOL)


def _encoder_kw():
    return dict(img_resolution=32, img_channels=6, channel_base=1 / 64,
                channel_max=32,
                model_kwargs={"num_ws": 3, "w_dim": 16, "output_mode": "W+"})


def test_encoder():
    jm, tm = jenc.Encoder(**_encoder_kw()), tenc.Encoder(**_encoder_kw())
    params, tm = bridged(jm, tm)
    img = np.random.RandomState(7).randn(2, 6, 32, 32).astype(np.float32)
    want = jm(params, nhwc(img))["ws"]
    np.testing.assert_allclose(tm(t(img))["ws"].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("psi", [1.0, 0.5])
def test_mask_mapping_disentangle(psi):
    kw = dict(z_dim=16, c_dim=25, in_resolution=32, in_channels=6, w_dim=16,
              num_ws=10, num_layers=2, geometry_layer=7,
              encoder_channel_base=1 / 64, encoder_channel_max=32)
    jm = jcond.MaskMappingNetworkDisentangle(**kw)
    tm = tcond.MaskMappingNetworkDisentangle(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(8))
    params["w_avg"] = 0.1 * jnp.ones((10, 16), jnp.float32)
    tm.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    rng = np.random.RandomState(8)
    z = rng.randn(2, 16).astype(np.float32)
    c = rng.randn(2, 25).astype(np.float32)
    mask = rng.randint(0, 6, (2, 32, 32, 1)).astype(np.float32)
    want = jm(params, jnp.asarray(z), jnp.asarray(c), batch={"mask": jnp.asarray(mask)},
              truncation_psi=psi)
    got = tm(t(z), t(c), batch={"mask": t(mask)}, truncation_psi=psi)
    assert got.shape == (2, 10, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("up,noise_mode", [(1, "const"), (2, "const"), (2, "none")])
def test_synthesis_layer(up, noise_mode):
    kw = dict(in_channels=6, out_channels=8, w_dim=16, resolution=16, up=up,
              conv_clamp=256)
    jm, tm = jsyn.SynthesisLayer(**kw), tsyn.SynthesisLayer(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(9))
    params["noise_strength"] = jnp.asarray(0.3, jnp.float32)
    tm.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 16 // up, 16 // up).astype(np.float32)
    w = rng.randn(2, 16).astype(np.float32)
    want = from_nhwc(jm(params, nhwc(x), jnp.asarray(w), noise_mode=noise_mode))
    got = tm(t(x), t(w), noise_mode=noise_mode)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_torgb_layer():
    jm, tm = jsyn.ToRGBLayer(8, 3, w_dim=16), tsyn.ToRGBLayer(8, 3, w_dim=16)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(10)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    w = rng.randn(2, 16).astype(np.float32)
    np.testing.assert_allclose(tm(t(x), t(w)).detach().numpy(),
                               from_nhwc(jm(params, nhwc(x), jnp.asarray(w))), **TOL)


@pytest.mark.parametrize("in_channels,up", [(0, 2), (8, 2), (8, 1)])
def test_synthesis_block(in_channels, up):
    """Skip architecture; up=1 is the SR stacks' SynthesisBlockNoUp."""
    kw = dict(in_channels=in_channels, out_channels=8, w_dim=16, resolution=16,
              img_channels=3)
    if up == 1:
        jm, tm = jsr.SynthesisBlockNoUp(is_last=True, **kw), tsr.SynthesisBlockNoUp(**kw)
    else:
        jm, tm = jsyn.SynthesisBlock(is_last=True, **kw), tsyn.SynthesisBlock(**kw)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(11)
    ws = rng.randn(2, tm.num_conv + tm.num_torgb, 16).astype(np.float32)
    s = 16 // up
    x = rng.randn(2, 8, s, s).astype(np.float32) if in_channels else None
    img = rng.randn(2, 3, s, s).astype(np.float32) if in_channels else None
    wx, wimg = jm(params, None if x is None else nhwc(x),
                  None if img is None else nhwc(img), jnp.asarray(ws),
                  noise_mode="const")
    gx, gimg = tm(None if x is None else t(x), None if img is None else t(img),
                  t(ws), noise_mode="const")
    np.testing.assert_allclose(gx.detach().numpy(), from_nhwc(wx), **TOL)
    np.testing.assert_allclose(gimg.detach().numpy(), from_nhwc(wimg), **TOL)


@pytest.mark.parametrize("num_fp16_res,force_fp32", [(0, False), (2, True)])
def test_synthesis_network_and_generator(num_fp16_res, force_fp32):
    """`force_fp32` runs the bf16-flagged blocks in f32, so it compares at
    the f32 tolerance."""
    kw = dict(w_dim=16, img_resolution=32, img_channels=6, channel_base=256,
              channel_max=16, num_fp16_res=num_fp16_res)
    jm = jsyn.Generator(z_dim=16, c_dim=0, mapping_kwargs={"num_layers": 2}, **kw)
    tm = tsyn.Generator(z_dim=16, c_dim=0, mapping_kwargs={"num_layers": 2}, **kw)
    params, tm = bridged(jm, tm)
    z = np.random.RandomState(12).randn(2, 16).astype(np.float32)
    want = jm(params, jnp.asarray(z), None, noise_mode="const",
              force_fp32=force_fp32)
    got = tm(t(z), None, noise_mode="const", force_fp32=force_fp32)
    np.testing.assert_allclose(got.detach().numpy(), from_nhwc(want), **TOL)


def _narrow(mod, blk, block_cls, img_ch, res0, res1):
    """Replace an SR module's hard-coded wide blocks with narrow ones of
    the same structure (JAX `_blk`-style), keeping its resize/broadcast."""
    if blk is None:
        mod.block0 = jsr._blk(block_cls, 32, 8, res0, img_ch, False, False, {})
        mod.block1 = jsr._blk(jsr.SynthesisBlock, 8, 4, res1, img_ch, True, False, {})
    else:
        mod.block0 = blk(block_cls, 32, 8, res0, img_ch, False)
        mod.block1 = blk(tsyn.SynthesisBlock, 8, 4, res1, img_ch, False)
    return mod


@pytest.mark.parametrize("name,img_ch,src", [
    ("SuperresolutionHybrid2X", 3, 32),
    ("SuperresolutionHybrid2X_semantic", 6, 64),
    ("SuperresolutionHybrid8XDC", 3, 64),
    ("SuperresolutionHybrid8XDC_semantic", 6, 128),
])
def test_superresolution(name, img_ch, src):
    """The SR classes with their blocks narrowed to 8/4 channels (the 8XDC
    stacks' 256/128-channel 512^2 convs are too heavy for a CPU test)."""
    res = 512 if "8XDC" in name else 128
    kw = dict(channels=32, img_resolution=res, sr_num_fp16_res=0,
              sr_antialias=True)
    if "semantic" in name:
        kw["semantic_channels"] = img_ch
    jm, tm = jsr.build_superresolution(name, **kw), tsr.build_superresolution(name, **kw)
    r0, r1 = (256, 512) if res == 512 else (64, 128)
    jcls = jsr.SynthesisBlock if res == 512 else jsr.SynthesisBlockNoUp
    tcls = tsyn.SynthesisBlock if res == 512 else tsr.SynthesisBlockNoUp
    _narrow(jm, None, jcls, img_ch, r0, r1)
    _narrow(tm, tsr._blk, tcls, img_ch, r0, r1)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(13)
    rgb = rng.randn(1, img_ch, src, src).astype(np.float32)
    x = rng.randn(1, 32, src, src).astype(np.float32)
    ws = rng.randn(1, 5, 512).astype(np.float32)
    want = jm(params, nhwc(rgb), nhwc(x), jnp.asarray(ws), noise_mode="none")
    got = tm(t(rgb), t(x), t(ws), noise_mode="none")
    assert got.shape == (1, img_ch, res, res)
    np.testing.assert_allclose(got.detach().numpy(), from_nhwc(want), **TOL)


# --- the reference's three block architectures ('orig', 'skip', 'resnet'):
# legacy TensorFlow pickles select them (utils/legacy_tf.py) --------------

@pytest.mark.parametrize("architecture", ["orig", "skip", "resnet"])
@pytest.mark.parametrize("in_channels,is_last", [(0, False), (8, False), (8, True)])
def test_synthesis_block_architectures(architecture, in_channels, is_last):
    """ToRGB in every block ('skip') or the last one only; the resnet skip
    (a 1x1 up-convolution, gain sqrt(1/2)); img upsampled only when given."""
    kw = dict(in_channels=in_channels, out_channels=8, w_dim=16, resolution=16,
              img_channels=3, is_last=is_last, architecture=architecture)
    jm, tm = jsyn.SynthesisBlock(**kw), tsyn.SynthesisBlock(**kw)
    params, tm = bridged(jm, tm)
    assert (tm.num_conv, tm.num_torgb) == (jm.num_conv, jm.num_torgb)
    rng = np.random.RandomState(14)
    ws = rng.randn(2, tm.num_conv + tm.num_torgb, 16).astype(np.float32)
    x = rng.randn(2, 8, 8, 8).astype(np.float32) if in_channels else None
    # 'orig' carries no image until its last block
    img = (rng.randn(2, 3, 8, 8).astype(np.float32)
           if in_channels and architecture != "orig" else None)
    wx, wimg = jax.jit(lambda p, x, img, ws: jm(p, x, img, ws, noise_mode="const"))(
        params, None if x is None else nhwc(x), None if img is None else nhwc(img),
        jnp.asarray(ws))
    gx, gimg = tm(None if x is None else t(x), None if img is None else t(img),
                  t(ws), noise_mode="const")
    np.testing.assert_allclose(gx.detach().numpy(), from_nhwc(wx), **TOL)
    assert (gimg is None) == (wimg is None)
    if wimg is not None:
        np.testing.assert_allclose(gimg.detach().numpy(), from_nhwc(wimg), **TOL)


@pytest.mark.parametrize("architecture,layer_kw", [
    ("orig", dict()), ("skip", dict(use_noise=False)),
    ("resnet", dict(activation="relu", resample_filter=[1, 2, 1]))])
def test_generator_architectures(architecture, layer_kw):
    """Whole generators: num_ws counts what each architecture builds;
    `use_noise`, `activation` and `resample_filter` reach the layers."""
    kw = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3,
              channel_base=256, channel_max=16, num_fp16_res=0,
              architecture=architecture, mapping_kwargs={"num_layers": 2}, **layer_kw)
    jm, tm = jsyn.Generator(**kw), tsyn.Generator(**kw)
    params, tm = bridged(jm, tm)
    assert tm.num_ws == jm.num_ws
    z = np.random.RandomState(15).randn(2, 16).astype(np.float32)
    want = jax.jit(lambda p, z: jm(p, z, None, noise_mode="const"))(params,
                                                                    jnp.asarray(z))
    got = tm(t(z), None, noise_mode="const")
    np.testing.assert_allclose(got.detach().numpy(), from_nhwc(want), **TOL)


@pytest.mark.parametrize("architecture", ["orig", "skip", "resnet"])
@pytest.mark.parametrize("in_channels", [0, 8])
def test_discriminator_block_architectures(architecture, in_channels):
    """FromRGB in the first block (every block with 'skip', whose image is
    downsampled alongside); the resnet skip; the image passes through."""
    kw = dict(in_channels=in_channels, tmp_channels=8, out_channels=12,
              img_channels=6, architecture=architecture)
    jm = jdisc.DiscriminatorBlock(resolution=16, first_layer_idx=0, **kw)
    tm = tdisc.DiscriminatorBlock(**kw)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(16)
    img = rng.randn(2, 6, 16, 16).astype(np.float32)
    x = rng.randn(2, 8, 16, 16).astype(np.float32) if in_channels else None
    wx, wimg = jax.jit(jm.__call__)(params, None if x is None else nhwc(x), nhwc(img))
    gx, gimg = tm(None if x is None else t(x), t(img))
    np.testing.assert_allclose(gx.numpy(), from_nhwc(wx), **TOL)
    assert (gimg is None) == (wimg is None)
    if wimg is not None:
        np.testing.assert_allclose(gimg.numpy(), from_nhwc(wimg), **TOL)


def test_discriminator_block_refuses_freeze_layers():
    """Training updates every layer, so a nonzero `freeze_layers` (which a
    legacy pickle may carry) is refused rather than dropped; 0 is taken."""
    kw = dict(in_channels=0, tmp_channels=8, out_channels=8, img_channels=3)
    assert tdisc.DiscriminatorBlock(freeze_layers=0, **kw).skip is not None
    with pytest.raises(ValueError, match="freeze_layers=2"):
        tdisc.DiscriminatorBlock(freeze_layers=2, **kw)


@pytest.mark.parametrize("architecture", ["orig", "skip", "resnet"])
def test_discriminator_epilogue_architectures(architecture):
    kw = dict(in_channels=8, cmap_dim=0, resolution=4, img_channels=3,
              architecture=architecture, mbstd_group_size=2)
    jm, tm = jdisc.DiscriminatorEpilogue(**kw), tdisc.DiscriminatorEpilogue(**kw)
    params, tm = bridged(jm, tm)
    rng = np.random.RandomState(17)
    x = rng.randn(4, 8, 4, 4).astype(np.float32)
    img = rng.randn(4, 3, 4, 4).astype(np.float32)
    want = jax.jit(lambda p, x, img: jm(p, x, img, None))(params, nhwc(x), nhwc(img))
    got = tm(t(x), t(img), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("architecture", ["orig", "skip", "resnet"])
def test_discriminator_architectures(architecture):
    kw = dict(c_dim=0, img_resolution=32, img_channels=3, architecture=architecture,
              channel_base=256, channel_max=16, num_fp16_res=0, conv_clamp=None,
              block_kwargs=dict(freeze_layers=0),
              epilogue_kwargs=dict(mbstd_group_size=2))
    jm, tm = jdisc.Discriminator(**kw), tdisc.Discriminator(**kw)
    params, tm = bridged(jm, tm)
    img = np.random.RandomState(18).randn(2, 3, 32, 32).astype(np.float32)
    want = jax.jit(lambda p, img: jm(p, img, None))(params, nhwc(img))
    got = tm(t(img), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
