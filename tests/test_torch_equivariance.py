"""The port's equivariance metrics (`pix2pix3d_tpu_torch/metrics/
equivariance.py`) against the JAX package's, on the CPU.

Each image operator on the same numpy images (NHWC there, NCHW here), at
the JAX suite's tolerances for the same operator against the reference
(tests/test_equivariance.py): integer translation and every mask 1e-6
(exact here: the same slices), fractional translation 1e-4, the
band-limited filter 1e-5, rotation 1e-3, pseudo-rotation 1e-4.  Both
packages compute them in float64 and return float32.

`compute_equivariance_metrics` on one small f32 `GeneratorS3` (JAX's `init`
bridged in; z from the same `RandomState(rng_seed)`) in both packages: the
three PSNRs within 1e-3 dB below 80 dB.  A PSNR is 10 log10(4 / mse), and
the packages' renders differ by ~1e-6 (f32, tests/test_torch_stylegan3.py):
against an rms error above 2e-4 (80 dB) that moves a score by under 1e-3
dB.  Above 80 dB the error itself nears that noise (integer translation
scores ~110 dB here: rms 6e-6), and the gate is 0.05 dB.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax

from pix2pix3d_tpu.metrics import equivariance as jeq
from pix2pix3d_tpu.metrics.metric_utils import MetricOptions as JOptions
from pix2pix3d_tpu.nn.stylegan3 import GeneratorS3 as JG

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.metrics import equivariance as teq
from pix2pix3d_tpu_torch.metrics.metric_utils import MetricOptions as TOptions
from pix2pix3d_tpu_torch.nn.stylegan3 import GeneratorS3 as TG

EXACT = dict(rtol=0, atol=1e-6)


def _img(n=2, h=20, w=24, c=3, seed=0):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


SHIFTS = [(0.1, -0.05), (-0.3, 0.2), (0.04, 0.49), (1.2, 0.0)]


@pytest.mark.parametrize("tx,ty", SHIFTS)
def test_integer_translation(tx, ty):
    x = _img()
    z, m = jeq.apply_integer_translation(x, tx, ty)
    zt, mt = teq.apply_integer_translation(nchw(x), tx, ty)
    np.testing.assert_allclose(nhwc(zt), z, **EXACT)
    np.testing.assert_allclose(nhwc(mt), m, **EXACT)


@pytest.mark.parametrize("tx,ty", SHIFTS)
def test_fractional_translation(tx, ty):
    x = _img(seed=1)
    z, m = jeq.apply_fractional_translation(x, tx, ty)
    zt, mt = teq.apply_fractional_translation(nchw(x), tx, ty)
    assert zt.dtype == torch.float32
    np.testing.assert_allclose(nhwc(zt), z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(nhwc(mt), m, **EXACT)


@pytest.mark.parametrize("angle", [0.4, -2.0])
@pytest.mark.parametrize("kw", [dict(amax=6, aflt=16, up=2), dict(amax=6, up=4),
                                dict(amax=6, up=1)])
def test_bandlimit_filter(angle, kw):
    """The rotation's (a=3, amax=6, up=4) and pseudo-rotation's (up=1)
    filters of the metric, and a small one."""
    want = jeq.construct_affine_bandlimit_filter(jeq.rotation_matrix(angle), a=3, **kw)
    got = teq.construct_affine_bandlimit_filter(teq.rotation_matrix(angle), a=3, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("angle", [0.4, -2.0, np.pi])
def test_fractional_rotation(angle):
    x = _img(n=2, h=16, w=20, seed=2)
    z, m = jeq.apply_fractional_rotation(x, angle)
    zt, mt = teq.apply_fractional_rotation(nchw(x), angle)
    np.testing.assert_allclose(nhwc(zt), z, rtol=0, atol=1e-3)
    np.testing.assert_allclose(nhwc(mt), m, **EXACT)
    assert 0 < m.mean() < 1


@pytest.mark.parametrize("angle", [0.5, -1.3])
def test_fractional_pseudo_rotation(angle):
    x = _img(n=2, h=16, w=20, seed=3)
    z, m = jeq.apply_fractional_pseudo_rotation(x, angle)
    zt, mt = teq.apply_fractional_pseudo_rotation(nchw(x), angle)
    np.testing.assert_allclose(nhwc(zt), z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(nhwc(mt), m, **EXACT)


def test_input_transform_is_restored_on_error():
    G = TG(z_dim=8, c_dim=0, w_dim=8, img_resolution=16, img_channels=3,
           channel_base=256, channel_max=16, num_layers=4,
           mapping_kwargs=dict(num_layers=1))
    buf = G.synthesis.input.transform
    buf.copy_(torch.eye(3) * 2)
    with pytest.raises(RuntimeError, match="inside"):
        with teq.input_transform(G, teq.rotation_matrix(0.3)):
            assert not torch.equal(buf, torch.eye(3) * 2)
            raise RuntimeError("inside")
    assert torch.equal(buf, torch.eye(3) * 2)


def test_metric_refuses_a_generator_without_input_transform():
    with pytest.raises(ValueError, match="alias-free"):
        teq.compute_equivariance_metrics(
            TOptions(G=torch.nn.Linear(2, 2), device="cpu"), num_samples=4,
            compute_eqt_int=True)


def test_metric_scores_match_jax():
    kw = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3,
              channel_base=1024, channel_max=16, num_layers=5, num_fp16_res=0,
              mapping_kwargs=dict(num_layers=1))
    jG, tG = JG(**kw), TG(**kw)
    params = jax.device_get(jax.jit(jG.init)(jax.random.PRNGKey(0)))
    tG.load_state_dict(bridge.params_from_jax(params), strict=True)
    flags = dict(num_samples=4, batch_size=2, compute_eqt_int=True,
                 compute_eqt_frac=True, compute_eqr=True)
    want = jeq.compute_equivariance_metrics(
        JOptions(G=jG, G_params=params, rng_seed=3), **flags)
    got = teq.compute_equivariance_metrics(
        TOptions(G=tG.eval(), rng_seed=3, device="cpu"), **flags)
    assert set(got) == set(want) == {"eqt_int", "eqt_frac", "eqr"}
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 10, (k, got[k])
        tol = 1e-3 if want[k] < 80 else 0.05
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    assert torch.equal(tG.synthesis.input.transform, torch.eye(3))
