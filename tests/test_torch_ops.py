"""The port's ops (`pix2pix3d_tpu_torch/ops`) against the JAX package's.

Same inputs (numpy, seeded) through both; NHWC on the JAX side, NCHW on the
port's.  All f32 on the CPU.  Tolerances: 1e-5 where both sides compute the
same sums in f32 (the JAX suite's own upfirdn2d oracle gate, test_ops.py),
1e-4 where transcendental implementations differ (XLA vs libm, as in
test_ops.py::test_bias_act_matches_torch).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the JAX package's ops/__init__ re-exports functions under the module names
jbias = importlib.import_module("pix2pix3d_tpu.ops.bias_act")
jconv = importlib.import_module("pix2pix3d_tpu.ops.conv2d_resample")
jresize = importlib.import_module("pix2pix3d_tpu.ops.resize")
jfir = importlib.import_module("pix2pix3d_tpu.ops.upfirdn2d")

from pix2pix3d_tpu_torch.ops import bias_act as tbias
from pix2pix3d_tpu_torch.ops import conv2d_resample as tconv
from pix2pix3d_tpu_torch.ops import precision
from pix2pix3d_tpu_torch.ops import resize as tresize
from pix2pix3d_tpu_torch.ops import upfirdn2d as tfir


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def from_nhwc(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


@pytest.mark.parametrize("act", list(jbias.activation_funcs.keys()))
def test_bias_act_matches_jax(act):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 7, 3, 3).astype(np.float32) * 3
    b = rng.randn(7).astype(np.float32)
    want = from_nhwc(jbias.bias_act(nhwc(x), jnp.asarray(b), dim=-1, act=act,
                                    clamp=4.0))
    got = tbias.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=1,
                         act=act, clamp=4.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bias_act_gain_and_clamp():
    x = torch.linspace(-10, 10, 21)
    got = tbias.bias_act(x[None], act="linear", gain=3.0, clamp=5.0)[0]
    np.testing.assert_allclose(got.numpy(),
                               np.clip(np.linspace(-10, 10, 21) * 3, -5, 5),
                               rtol=1e-6)


@pytest.mark.parametrize("up,down,padding", [
    (1, 1, 0),
    (1, 1, 2),
    (2, 1, [2, 1, 2, 1]),
    (1, 2, [1, 1, 1, 1]),
    (2, 2, [3, 2, 3, 2]),
    (1, 1, [-1, 2, 0, -1]),
    (4, 1, [3, 1, 3, 1]),
])
@pytest.mark.parametrize("ftaps", [None, [1, 3, 3, 1], [1, 2, 1]])
def test_upfirdn2d_matches_jax(up, down, padding, ftaps):
    """The grid of tests/test_ops.py::test_upfirdn2d_matches_numpy_oracle."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    jf = jfir.setup_filter(ftaps) if ftaps is not None else None
    tf = tfir.setup_filter(ftaps) if ftaps is not None else None
    want = from_nhwc(jfir.upfirdn2d(nhwc(x), jf, up=up, down=down,
                                    padding=padding))
    got = tfir.upfirdn2d(torch.from_numpy(x), tf, up=up, down=down,
                         padding=padding).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_setup_filter_and_separable_path_match_jax():
    taps = [1, 2, 3, 4, 4, 3, 2, 1]
    for kw in ({}, {"separable": False}, {"flip_filter": True, "gain": 4}):
        np.testing.assert_allclose(tfir.setup_filter(taps, **kw).numpy(),
                                   np.asarray(jfir.setup_filter(taps, **kw)),
                                   rtol=1e-6)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 16, 16).astype(np.float32)
    want = from_nhwc(jfir.upfirdn2d(nhwc(x), jfir.setup_filter(taps), up=2,
                                    padding=[4, 3, 4, 3], gain=4))
    got = tfir.upfirdn2d(torch.from_numpy(x), tfir.setup_filter(taps), up=2,
                         padding=[4, 3, 4, 3], gain=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["filter2d", "upsample2d"])
@pytest.mark.parametrize("padding", [0, [1, 0, 2, 1]])
def test_resample_helpers_match_jax(name, padding):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    want = from_nhwc(getattr(jfir, name)(
        nhwc(x), jfir.setup_filter([1, 3, 3, 1]), padding=padding))
    got = getattr(tfir, name)(torch.from_numpy(x),
                              tfir.setup_filter([1, 3, 3, 1]),
                              padding=padding).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("up,down,padding,flip_weight", [
    (1, 1, 1, True),
    (1, 1, [0, 2, 1, 0], True),
    (2, 1, 1, False),
    (1, 2, 1, True),
    (2, 2, 1, False),
])
@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_resample_matches_jax(up, down, padding, flip_weight, groups):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 12, 12).astype(np.float32)
    w = rng.randn(3, 3, 4 // groups, 6).astype(np.float32)      # HWIO
    f = [1, 3, 3, 1]
    want = from_nhwc(jconv.conv2d_resample(
        nhwc(x), jnp.asarray(w), f=jfir.setup_filter(f), up=up, down=down,
        padding=padding, groups=groups, flip_weight=flip_weight))
    got = tconv.conv2d_resample(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        f=tfir.setup_filter(f), up=up, down=down, padding=padding,
        groups=groups, flip_weight=flip_weight).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("src,dst,antialias", [
    (128, 512, True),     # 8XDC SR input adapter, seg2cat
    (32, 64, True),       # 2X SR input adapter, the tests' small generator
    (64, 128, False),
    (64, 32, True),       # downsampling: antialias widens the kernel
])
def test_resize_bilinear_matches_jax(src, dst, antialias):
    rng = np.random.RandomState(5)
    x = rng.randn(1, 3, src, src).astype(np.float32)
    want = from_nhwc(jresize.resize_bilinear(nhwc(x), dst, antialias=antialias))
    got = tresize.resize_bilinear(torch.from_numpy(x), dst,
                                  antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst,antialias", [
    ((128, 128), (512, 512), True),   # DualDiscriminator: raw image up to 512
    ((512, 512), (128, 128), True),   # the real image's raw target
    ((32, 32), (66, 66), False),      # filtered_resizing 'classic': size*2+2
    ((24, 40), (16, 56), True),       # non-square, one axis each way
    ((24, 40), (16, 56), False),
])
def test_resize_bilinear_and_its_gradient_match_interpolate(src, dst, antialias):
    """The products' values and input gradient are F.interpolate's (f32,
    other summation orders: 1e-5)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 3, *src).astype(np.float32))
    gy = torch.from_numpy(rng.randn(2, 3, *dst).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = tresize.resize_bilinear(xa, dst, antialias=antialias)
    want = torch.nn.functional.interpolate(xb, size=dst, mode="bilinear",
                                           align_corners=False, antialias=antialias)
    (got * gy).sum().backward()
    (want * gy).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert tresize.resize_bilinear(x.bfloat16(), dst, antialias).dtype == torch.bfloat16


def test_precision_policy_sets_and_restores_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with precision.policy(False):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with precision.scope("default"):
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        with precision.scope("highest"):
            assert not torch.backends.cudnn.allow_tf32
        with precision.scope(None):
            assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == old
