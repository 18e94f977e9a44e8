"""The port's training networks and small training pieces against the JAX
package: `minibatch_stddev`, `filtered_resizing` (both filter modes),
`DualDiscriminator` (weights from the JAX `init`, forward and the input
gradient R1 takes, with `raw_fade` and `disc_c_noise` on JAX's draw), the
LPIPS module on the JAX module's own random VGG (`PRNGKey(80085)`), the
EMA, the stats moments and the lazy Adam's settings.

f32 on the CPU.  Tolerances: 1e-4 (as tests/test_torch_nn.py: f32 on both
sides, other summation orders); the input gradient 1e-3 of its largest
entry + 1e-6 (as the phase gradients, tests/test_torch_train_phases.py).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn import discriminator as jdisc
from pix2pix3d_tpu.nn.layers import minibatch_stddev as j_mbstd
from pix2pix3d_tpu.parallel.trainer import _lazy_adam
from pix2pix3d_tpu.train import ema as jema
from pix2pix3d_tpu.train.lpips import LPIPS as JLPIPS
from pix2pix3d_tpu.train.stats import moments as j_moments

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.nn.layers import minibatch_stddev
from pix2pix3d_tpu_torch.ops.upfirdn2d import setup_filter
from pix2pix3d_tpu_torch.train import ema as tema
from pix2pix3d_tpu_torch.train.lpips import LPIPS
from pix2pix3d_tpu_torch.train.stats import Collector, moments
from pix2pix3d_tpu_torch.parallel.trainer import _lazy_adam as t_lazy_adam

from test_torch_train_phases import two_torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def from_nhwc(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize("n,group,f", [(4, 4, 1), (4, 2, 1), (2, 4, 2), (6, 3, 2)])
def test_minibatch_stddev(n, group, f):
    x = np.random.RandomState(n + group).randn(n, 8, 4, 4).astype(np.float32)
    want = from_nhwc(j_mbstd(nhwc(x), group, f))
    got = minibatch_stddev(torch.from_numpy(x), group, f).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode,size", [("antialiased", 16), ("antialiased", 64),
                                       ("classic", 16), ("none", 24), (0.3, 16)])
def test_filtered_resizing(mode, size):
    x = np.random.RandomState(3).randn(2, 5, 32, 32).astype(np.float32)
    f = [1, 3, 3, 1]
    want = from_nhwc(jdisc.filtered_resizing(nhwc(x), size, jdisc.setup_filter(f),
                                             filter_mode=mode))
    got = tdisc.filtered_resizing(torch.from_numpy(x), size, setup_filter(f),
                                  filter_mode=mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)


D_KW = dict(c_dim=25, img_resolution=64, channel_base=256, channel_max=16,
            num_fp16_res=0, epilogue_kwargs={"mbstd_group_size": 2})


@pytest.fixture(scope="module")
def dual():
    jm = jdisc.DualDiscriminator(img_channels=3, disc_c_noise=0.5, **D_KW)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(4)))
    tm = tdisc.DualDiscriminator(img_channels=3, disc_c_noise=0.5, **D_KW)
    tm.load_state_dict(bridge.params_from_jax(params), strict=True)
    return jm, params, tm


def _d_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, 64, 64).astype(np.float32),
            rng.randn(2, 3, 16, 16).astype(np.float32),
            rng.randn(2, 25).astype(np.float32))


@pytest.mark.parametrize("raw_fade", [None, 0.4])
def test_dual_discriminator_and_its_input_gradient(dual, monkeypatch, raw_fade):
    """Forward, and R1's inner gradient w.r.t. the image and the raw image,
    with the conditioning noise drawn by JAX and handed to the port."""
    jm, params, tm = dual
    img, raw, c = _d_inputs()
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, c.shape))

    def jf(image, image_raw):
        return jnp.sum(jm(params, {"image": image, "image_raw": image_raw},
                          jnp.asarray(c), rng=key, raw_fade=raw_fade))
    want, (gi, gr) = jax.value_and_grad(jf, argnums=(0, 1))(nhwc(img), nhwc(raw))

    draws = [noise]
    monkeypatch.setattr(tdisc, "draw_normal",
                        lambda g, shape, device: torch.from_numpy(draws.pop(0)))
    ti = torch.from_numpy(img).requires_grad_(True)
    tr = torch.from_numpy(raw).requires_grad_(True)
    out = tm({"image": ti, "image_raw": tr}, torch.from_numpy(c),
             generator=torch.Generator(), raw_fade=raw_fade).sum()
    g_img, g_raw = torch.autograd.grad(out, [ti, tr])
    assert not draws
    np.testing.assert_allclose(out.item(), float(want), **TOL)
    for got, w in ((g_img, gi), (g_raw, gr)):
        w = from_nhwc(w)
        assert np.abs(got.numpy() - w).max() <= 1e-3 * np.abs(w).max() + 1e-6


def test_discriminator_conditioning_noise_needs_a_generator(dual):
    _, _, tm = dual
    img, raw, c = _d_inputs()
    with pytest.raises(ValueError, match="torch.Generator"):
        tm({"image": torch.from_numpy(img), "image_raw": torch.from_numpy(raw)},
           torch.from_numpy(c))


def test_single_and_plain_discriminators():
    kw = dict(D_KW, img_channels=3)
    for jcls, tcls in ((jdisc.Discriminator, tdisc.Discriminator),
                       (jdisc.SingleDiscriminator, tdisc.SingleDiscriminator)):
        jm = jcls(**kw)
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(5)))
        tm = tcls(**kw)
        tm.load_state_dict(bridge.params_from_jax(params), strict=True)
        img, _, c = _d_inputs(1)
        jin = nhwc(img) if jcls is jdisc.Discriminator else {"image": nhwc(img)}
        tin = (torch.from_numpy(img) if tcls is tdisc.Discriminator
               else {"image": torch.from_numpy(img)})
        want = np.asarray(jm(params, jin, jnp.asarray(c)))
        with torch.no_grad():
            got = tm(tin, torch.from_numpy(c)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_discriminator_fp16_blocks_run_in_bf16():
    """num_fp16_res blocks hold bf16 tensors, the epilogue f32, as in JAX's
    precision policy."""
    tm = tdisc.DualDiscriminator(img_channels=3, **dict(D_KW, num_fp16_res=2))
    dtypes = []
    for res in tm.block_resolutions:
        getattr(tm, f"b{res}").register_forward_hook(
            lambda m, i, o: dtypes.append(o[0].dtype))
    img, raw, c = _d_inputs()
    with torch.no_grad():
        out = tm({"image": torch.from_numpy(img), "image_raw": torch.from_numpy(raw)},
                 torch.from_numpy(c), generator=torch.Generator())
    assert out.dtype == torch.float32
    assert dtypes[:2] == [torch.bfloat16, torch.bfloat16]
    assert set(dtypes[2:]) == {torch.float32}


def test_lpips_on_the_jax_random_vgg():
    jl = JLPIPS()
    tl = LPIPS()
    tl.load_params(jax.device_get(jl.params))
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 3, 48, 48)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 48, 48)).astype(np.float32)
    want = np.asarray(jl(nhwc(x), nhwc(y)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert not tl.has_pretrained and not any(p.requires_grad for p in tl.parameters())


def test_lpips_reads_the_jax_npz_layout(tmp_path):
    jl = JLPIPS()
    path = tmp_path / "lpips.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in jl.params.items()})
    tl = LPIPS(weights_path=str(path))
    assert tl.has_pretrained
    ref = LPIPS()
    ref.load_params(jax.device_get(jl.params))
    for k, v in ref.state_dict().items():
        assert torch.equal(tl.state_dict()[k], v), k


def test_ema_and_buffer_copy_match_jax():
    from pix2pix3d_tpu_torch.nn.synthesis import SynthesisLayer
    from pix2pix3d_tpu.nn.synthesis import SynthesisLayer as JLayer
    kw = dict(in_channels=4, out_channels=4, w_dim=8, resolution=8)
    jm = JLayer(**kw)
    p0 = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1)))
    p1 = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2)))
    e, g = SynthesisLayer(**kw), SynthesisLayer(**kw)
    e.load_state_dict(bridge.params_from_jax(p0))
    g.load_state_dict(bridge.params_from_jax(p1))
    beta = 0.731
    want = jema.copy_buffers(jema.ema_update(p0, p1, beta), p1)
    tema.ema_update(e, g, beta)
    tema.copy_buffers(e, g)
    got = bridge.params_to_jax(e)
    for k in ("weight", "bias", "noise_strength", "noise_const"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    assert np.array_equal(got["noise_const"], np.asarray(p1["noise_const"]))
    for args in ((4, 0, 10), (4, 400, 1.25), (32, 10 ** 6, 10)):
        assert tema.ema_beta(*args) == jema.ema_beta(*args)


def test_moments_and_collector():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    np.testing.assert_allclose(moments(torch.from_numpy(x)).numpy(),
                               np.asarray(j_moments(x)), rtol=1e-6)
    col = Collector()
    col.update({"a": moments(torch.from_numpy(x)).numpy()})
    col.update({"a": moments(torch.from_numpy(x[:1])).numpy()})
    allx = np.concatenate([x.ravel(), x[:1].ravel()])
    assert abs(col.mean("a") - allx.mean()) < 1e-6
    assert abs(col.std("a") - allx.std()) < 1e-5
    assert np.isnan(col.mean("b"))


@pytest.mark.parametrize("interval", [None, 4, 16])
def test_lazy_adam_settings_match_optax(interval):
    """lr * r and betas ** r, r = I / (I + 1): one step on the same gradient
    moves the parameter as optax's `_lazy_adam` does."""
    g = np.random.RandomState(1).randn(7).astype(np.float32)
    p = torch.zeros(7, requires_grad=True)
    opt = t_lazy_adam([p], 0.002, (0.0, 0.99), 1e-8, interval)
    for _ in range(3):
        p.grad = torch.from_numpy(g)
        opt.step()
    jopt = _lazy_adam(0.002, (0.0, 0.99), 1e-8, interval)
    jp = jnp.zeros(7)
    st = jopt.init(jp)
    for _ in range(3):
        upd, st = jopt.update(jnp.asarray(g), st, jp)
        jp = jp + upd
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-8)
