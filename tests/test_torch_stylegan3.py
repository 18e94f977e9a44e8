"""The port's StyleGAN3 stack (`pix2pix3d_tpu_torch/nn/stylegan3.py`,
`ops/filtered_lrelu.py`) against the JAX package's, on the CPU.

Weights come from JAX's `init` through `bridge.params_from_jax`; the same
numpy inputs go to both packages (NHWC there, NCHW here).

Tolerances: the filter design exactly (the same scipy/numpy code);
filtered_lrelu, SynthesisInput and each f32 layer 1e-4 (rtol = atol, the
JAX suite's filtered_lrelu tolerance, tests/test_stylegan3.py); the whole
generator 5e-3 (that suite's generator tolerance); `updated_magnitude_ema`
1e-6 relative (one f32 mean of squares).  bf16 (filtered_lrelu on bf16
inputs, a layer with `use_fp16`): each of the op's four stages rounds to
bf16, whose unit roundoff is 2^-9, and the two frameworks may round a sum
differently by one step; the gate is 4 bf16 steps (2^-6) of the output's
largest magnitude, and at most 1% of the entries more than one step apart.
The bridge round trip is bit for bit.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn import stylegan3 as js3
from pix2pix3d_tpu.ops.filtered_lrelu import filtered_lrelu as jfl
from pix2pix3d_tpu.utils.misc import tree_paths as jtree_paths

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.nn import stylegan3 as ts3
from pix2pix3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu as tfl
from pix2pix3d_tpu_torch.utils.misc import tree_paths

TOL = dict(rtol=1e-4, atol=1e-4)
GEN_TOL = dict(rtol=5e-3, atol=5e-3)
BF16_STEP = 2.0 ** -8


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def from_nhwc(y):
    return np.transpose(np.asarray(y, np.float32), (0, 3, 1, 2))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_bf16_close(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 4 * BF16_STEP * scale, (err.max(), scale)
    assert (err > BF16_STEP * scale).mean() <= 0.01


def _kaiser(taps, cutoff, fs):
    return js3.design_lowpass_filter(taps, cutoff, cutoff, fs)


def _radial(taps, cutoff, fs):
    return js3.design_lowpass_filter(taps, cutoff, cutoff, fs, radial=True)


# (up, down, up filter, down filter, padding, gain, slope, clamp)
FL_CASES = {
    "up2-down2": (2, 2, lambda: _kaiser(12, 4.0, 32), lambda: _kaiser(12, 4.0, 32),
                  [11, 10, 11, 10], np.sqrt(2), 0.2, 256),
    "up4-radial-down2": (4, 2, lambda: _kaiser(24, 2.0, 32), lambda: _radial(12, 5.0, 32),
                         [19, 15, 17, 18], np.sqrt(2), 0.2, None),
    "up1-down4": (1, 4, lambda: None, lambda: _kaiser(24, 3.0, 32),
                  [13, 12, 13, 12], np.sqrt(2), 0.2, 8.0),
    "torgb": (1, 1, lambda: None, lambda: None, 0, 1, 1, 256),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FL_CASES))
def test_filtered_lrelu(case, dtype):
    up, down, fu, fd, padding, gain, slope, clamp = FL_CASES[case]
    fu, fd = fu(), fd()
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 12, 12) * 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp)
    want = jax.jit(lambda x, b: jfl(x, fu=fu, fd=fd, b=b, **kw))(
        nhwc(x).astype(jdt), jnp.asarray(b).astype(jdt))
    got = tfl(t(x).to(tdt), fu=None if fu is None else t(np.asarray(fu)),
              fd=None if fd is None else t(np.asarray(fd)), b=t(b).to(tdt), **kw)
    assert got.dtype == tdt
    want = from_nhwc(want)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        assert_bf16_close(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kw", [dict(numtaps=12, cutoff=2.0, width=1.5, fs=16),
                                dict(numtaps=24, cutoff=6.0, width=4.0, fs=32),
                                dict(numtaps=24, cutoff=6.0, width=4.0, fs=32, radial=True),
                                dict(numtaps=1, cutoff=6.0, width=4.0, fs=32)])
def test_design_lowpass_filter_is_exact(kw):
    want = js3.design_lowpass_filter(**kw)
    got = ts3.design_lowpass_filter(**kw)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_synthesis_input_under_a_transform():
    """Random affine weights (init gives 0) and a rotation + translation in
    the `transform` buffer, as the equivariance metrics set it."""
    jm = js3.SynthesisInput(w_dim=16, channels=12, size=20, sampling_rate=16,
                            bandwidth=2.0)
    tm = ts3.SynthesisInput(w_dim=16, channels=12, size=20, sampling_rate=16,
                            bandwidth=2.0)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(1)
    params["affine"]["weight"] = rng.randn(16, 4).astype(np.float32) * 0.3
    angle = 0.7
    params["transform"] = np.array([[np.cos(angle), np.sin(angle), 0.1],
                                    [-np.sin(angle), np.cos(angle), -0.05],
                                    [0, 0, 1]], np.float32)
    tm.load_state_dict(bridge.params_from_jax(params), strict=True)
    w = rng.randn(3, 16).astype(np.float32)
    want = jax.jit(jm.__call__)(params, jnp.asarray(w))
    got = tm(t(w))
    assert tuple(got.shape) == (3, 12, 20, 20)
    np.testing.assert_allclose(got.numpy(), from_nhwc(want), **TOL)


def _kwargs(kind, num_fp16_res=0):
    kw = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3,
              channel_base=1024, channel_max=32, num_layers=5, num_critical=2,
              num_fp16_res=num_fp16_res, mapping_kwargs=dict(num_layers=2))
    if kind == "R":   # StyleGAN3-R: 1x1 convs, radial filters, twice the channels
        kw.update(conv_kernel=1, use_radial_filters=True, channel_base=2048,
                  channel_max=64)
    return kw


@pytest.fixture(scope="module", params=["T", "R", "T-fp16"])
def generators(request):
    """(kind, JAX GeneratorS3, its params as numpy, the port's)."""
    kw = _kwargs(request.param[0], 4 if request.param == "T-fp16" else 0)
    jG = js3.GeneratorS3(**kw)
    params = jax.device_get(jax.jit(jG.init)(jax.random.PRNGKey(0)))
    tG = ts3.GeneratorS3(**kw)
    tG.load_state_dict(bridge.params_from_jax(params), strict=True)
    return request.param, jG, params, tG.eval()


def test_generator_matches_jax(generators):
    """T and R at f32; T with bf16 layers run with `force_fp32`."""
    kind, jG, params, tG = generators
    force = kind == "T-fp16"
    z = np.random.RandomState(2).randn(2, 16).astype(np.float32)
    want = jax.jit(lambda p, z: jG(p, z, None, force_fp32=force))(params, jnp.asarray(z))
    got = tG(t(z), None, force_fp32=force)
    assert tG.num_ws == jG.num_ws
    assert tuple(got.shape) == (2, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), from_nhwc(want), **GEN_TOL)


def _layer_case(generators, which):
    _, jG, params, tG = generators
    names = jG.synthesis.layer_names
    name = {"torgb": names[-1], "critical": names[-2], "first": names[0]}[which]
    return (jG.synthesis.layers[names.index(name)], params["synthesis"][name],
            getattr(tG.synthesis, name))


@pytest.mark.parametrize("which", ["torgb", "critical", "first"])
def test_synthesis_layer(generators, which):
    """The ToRGB layer, a critically sampled layer and the first layer
    (bf16 in "T-fp16"), with a magnitude EMA other than 1."""
    kind, _, _, _ = generators
    jl, lp, tl = _layer_case(generators, which)
    lp = dict(lp, magnitude_ema=np.float32(2.5))
    tl.magnitude_ema.fill_(2.5)
    rng = np.random.RandomState(3)
    x = rng.randn(2, jl.in_channels, *jl.in_size).astype(np.float32)
    w = rng.randn(2, 16).astype(np.float32)
    want = from_nhwc(jax.jit(jl.__call__)(lp, nhwc(x), jnp.asarray(w)))
    got = tl(t(x), t(w))
    assert got.shape == want.shape
    if tl.use_fp16:
        assert kind == "T-fp16" and got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    tl.magnitude_ema.fill_(1.0)
    new = tl.updated_magnitude_ema(t(x))
    np.testing.assert_allclose(new.numpy(), np.asarray(jl.updated_magnitude_ema(
        dict(lp, magnitude_ema=np.float32(1.0)), nhwc(x))), rtol=1e-6)


def test_bridge_round_trip_is_bit_exact(generators):
    """`params_to_jax(params_from_jax(tree))` gives JAX's tree back: every
    leaf (freqs, phases, transform, magnitude_ema and the square input
    weight included) with its dtype and bits.  The port holds the input
    weight transposed, as the bridge gives every 2-D weight (the square
    shape would hide the other orientation; test_synthesis_input_under_a_
    transform and the generator test show the product is JAX's)."""
    _, jG, params, tG = generators
    back = bridge.params_to_jax(bridge.params_from_jax(params))
    want = {p: np.asarray(v) for p, v in jtree_paths(params)}
    got = dict(tree_paths(back))
    assert got.keys() == want.keys()
    for p in want:
        assert got[p].dtype == want[p].dtype and got[p].shape == want[p].shape, p
        np.testing.assert_array_equal(got[p], want[p], err_msg=str(p))
    assert {p[-1] for p in want} >= {"freqs", "phases", "transform", "magnitude_ema"}
    np.testing.assert_array_equal(tG.synthesis.input.weight.numpy(),
                                  params["synthesis"]["input"]["weight"].T)
    assert len(tG.state_dict()) == len(want)
