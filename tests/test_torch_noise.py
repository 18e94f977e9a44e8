"""noise_mode='random' in the port's synthesis layers, blocks, SR stacks and
generator, against the JAX package.

The two frameworks draw different numbers from their generators, so the
JAX side's own draws -- `jax.random.normal(key, [N, res, res, 1])` with
the keys its layers split off, in the order the layers run -- are computed
here and handed to the port in place of its `draw_noise`.  The port's own
draws (`torch.Generator`) are checked for what they must do: equal seeds
give equal outputs, zero noise strength gives the const result, and a
random draw without a generator raises, as JAX asserts on a missing key.

f32 on the CPU at narrow widths; tolerance 1e-4 as in tests/test_torch_nn.py.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn import superresolution as jsr
from pix2pix3d_tpu.nn import synthesis as jsyn

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.models.triplane import init_parameters
from pix2pix3d_tpu_torch.nn import superresolution as tsr
from pix2pix3d_tpu_torch.nn import synthesis as tsyn

from test_torch_generator import _request, _small_cfg
from test_torch_nn import _narrow, from_nhwc, nhwc, t

TOL = dict(rtol=1e-4, atol=1e-4)
STRENGTH = 0.7


def _with_strength(params, value):
    """The JAX param tree with every noise_strength set to `value`."""
    if isinstance(params, dict):
        return {k: (jnp.asarray(value, jnp.float32) if k == "noise_strength"
                    else _with_strength(v, value)) for k, v in params.items()}
    return params


def _bridged(jm, tm, seed):
    params = _with_strength(jax.jit(jm.init)(jax.random.PRNGKey(seed)), STRENGTH)
    tm.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return params, tm.eval()


def _layer_noise(key, n, res):
    return np.asarray(jax.random.normal(key, (n, res, res, 1), dtype=jnp.float32))


def _block_noise(block, key, n):
    """The draws of a JAX SynthesisBlock's layers, in the order they run."""
    keys = jax.random.split(key, 2)
    if block.in_channels == 0:
        return [_layer_noise(keys[0], n, block.resolution)]
    return [_layer_noise(keys[0], n, block.resolution),
            _layer_noise(keys[1], n, block.resolution)]


@pytest.fixture
def shared_noise(monkeypatch):
    """Queue of JAX draws (NHWC) that the port's draw_noise hands out in
    order, as [N, 1, res, res] tensors; asserts each shape."""
    queue = []

    def draw(shape, generator, device):
        assert isinstance(generator, torch.Generator)
        arr = queue.pop(0)
        assert tuple(shape) == (arr.shape[0], 1, arr.shape[1], arr.shape[2])
        return torch.from_numpy(np.transpose(arr, (0, 3, 1, 2)).copy()).to(device)

    monkeypatch.setattr(tsyn, "draw_noise", draw)
    yield queue
    assert not queue, "the port drew fewer noise maps than the JAX package"


@pytest.mark.parametrize("up", [1, 2])
def test_synthesis_layer_random_noise(shared_noise, up):
    kw = dict(in_channels=6, out_channels=8, w_dim=16, resolution=16, up=up,
              conv_clamp=256)
    jm, tm = jsyn.SynthesisLayer(**kw), tsyn.SynthesisLayer(**kw)
    params, tm = _bridged(jm, tm, 9)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 16 // up, 16 // up).astype(np.float32)
    w = rng.randn(2, 16).astype(np.float32)
    key = jax.random.PRNGKey(21)
    shared_noise.append(_layer_noise(key, 2, 16))
    want = from_nhwc(jm(params, nhwc(x), jnp.asarray(w), noise_mode="random", rng=key))
    with torch.no_grad():
        got = tm(t(x), t(w), noise_mode="random", generator=torch.Generator())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_synthesis_network_random_noise(shared_noise):
    kw = dict(w_dim=16, img_resolution=32, img_channels=6, channel_base=256,
              channel_max=16, num_fp16_res=0)
    jm, tm = jsyn.SynthesisNetwork(**kw), tsyn.SynthesisNetwork(**kw)
    params, tm = _bridged(jm, tm, 12)
    ws = np.random.RandomState(12).randn(2, tm.num_ws, 16).astype(np.float32)
    key = jax.random.PRNGKey(22)
    for res, k in zip(jm.block_resolutions,
                      jax.random.split(key, len(jm.block_resolutions))):
        shared_noise.extend(_block_noise(jm.blocks[res], k, 2))
    want = from_nhwc(jm(params, jnp.asarray(ws), noise_mode="random", rng=key))
    with torch.no_grad():
        got = tm(t(ws), noise_mode="random", generator=torch.Generator())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_superresolution_random_noise(shared_noise):
    """The 2X SR pair's class with its blocks narrowed, as
    tests/test_torch_nn.py::test_superresolution builds it."""
    name = "SuperresolutionHybrid2X"
    kw = dict(channels=32, img_resolution=128, sr_num_fp16_res=0, sr_antialias=True)
    jm, tm = jsr.build_superresolution(name, **kw), tsr.build_superresolution(name, **kw)
    _narrow(jm, None, jsr.SynthesisBlockNoUp, 3, 64, 128)
    _narrow(tm, tsr._blk, tsr.SynthesisBlockNoUp, 3, 64, 128)
    params, tm = _bridged(jm, tm, 13)
    rng = np.random.RandomState(13)
    rgb = rng.randn(1, 3, 32, 32).astype(np.float32)
    x = rng.randn(1, 32, 32, 32).astype(np.float32)
    ws = rng.randn(1, 5, 512).astype(np.float32)
    key = jax.random.PRNGKey(23)
    k0, k1 = jax.random.split(key, 2)
    shared_noise.extend(_block_noise(jm.block0, k0, 1) + _block_noise(jm.block1, k1, 1))
    want = from_nhwc(jm(params, nhwc(rgb), nhwc(x), jnp.asarray(ws),
                        noise_mode="random", rng=key))
    with torch.no_grad():
        got = tm(t(rgb), t(x), t(ws), noise_mode="random", generator=torch.Generator())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_random_is_the_default_and_needs_a_generator():
    layer = tsyn.SynthesisLayer(4, 4, w_dim=8, resolution=8)
    init_parameters(layer, torch.Generator().manual_seed(0))   # affine too
    x, w = torch.randn(1, 4, 8, 8), torch.randn(1, 8)
    with pytest.raises(ValueError, match="torch.Generator"):
        layer(x, w)
    with torch.no_grad():
        layer.noise_strength.fill_(STRENGTH)
        a = layer(x, w, generator=torch.Generator().manual_seed(5))
        b = layer(x, w, generator=torch.Generator().manual_seed(5))
        c = layer(x, w, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def generator():
    return tbuild(device="cpu", **_small_cfg(tconfig))


def _forward(G, gen, **kw):
    z, mask, pose = _request(np.pi / 2 + 0.1, np.pi / 2, 4)
    with torch.no_grad():
        return G(torch.from_numpy(z), torch.from_numpy(pose),
                 {"mask": torch.from_numpy(mask), "pose": torch.from_numpy(pose)},
                 neural_rendering_resolution=32, generator=gen, **kw)


def test_generator_random_noise(generator):
    """The generator's default noise mode draws from the generator it is
    given; at the init's zero noise strength that is the const result."""
    G = generator
    with pytest.raises(ValueError, match="torch.Generator"):
        _forward(G, None)
    const = _forward(G, None, noise_mode="const")
    zero = _forward(G, torch.Generator().manual_seed(1))
    for key in ("image", "image_raw", "semantic"):
        assert torch.equal(zero[key], const[key]), key
    strengths = [p for n, p in G.named_parameters() if n.endswith("noise_strength")]
    try:
        for p in strengths:
            p.data.fill_(STRENGTH)
        a = _forward(G, torch.Generator().manual_seed(1))
        b = _forward(G, torch.Generator().manual_seed(1))
        c = _forward(G, torch.Generator().manual_seed(2))
    finally:
        for p in strengths:
            p.data.zero_()
    for key in ("image", "image_raw", "semantic"):
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["image"], c["image"])
    assert not torch.equal(a["image"], const["image"])
