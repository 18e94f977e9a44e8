"""The training loop's sinks and its snapshot trend against the JAX package:
the TensorBoard event writer (`train/tb.py`), the wandb sink, the Frechet
math (`metrics/frechet_inception_distance.py`), `FeatureStats` and the
random-convolution proxy (`metrics/metric_utils.py`), and the loop's
real-vs-fake trend.

- TensorBoard: with the wall time fixed, the port's event file equals the
  JAX writer's byte for byte for the same scalars (NaN skipped).  An image
  record holds the port's own PNG (no Pillow on the card's machine): it
  equals the record the JAX writer's encoder makes around those PNG bytes,
  and the PNG decodes (Pillow) to the same pixels.
- The Frechet math and `FeatureStats` are numpy in both packages, the same
  arithmetic: equal to 1e-12 relative.
- `RandomConvFeatures` with JAX's weights handed in, on the CPU: within
  1e-4 of the output's largest value (f32 convolutions on both sides sum in
  other orders); the loop's trend on those weights within 1e-4 relative of
  JAX's.  With its own draws (`torch.Generator`), the port's proxy gives
  other values than JAX's: not compared.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import io
import math
import os
import struct
import time

import numpy as np
import PIL.Image
import pytest
import torch

from pix2pix3d_tpu.metrics import frechet_inception_distance as jfid
from pix2pix3d_tpu.metrics import metric_utils as jmu
from pix2pix3d_tpu.train import loop as jloop
from pix2pix3d_tpu.train import tb as jtb

from pix2pix3d_tpu_torch.metrics import frechet_inception_distance as tfid
from pix2pix3d_tpu_torch.metrics import metric_utils as tmu
from pix2pix3d_tpu_torch.train import loop as tloop
from pix2pix3d_tpu_torch.train import tb as ttb
from pix2pix3d_tpu_torch.train.wandb_sink import WandbSink

from test_torch_train_phases import two_torch_threads  # noqa: F401  (autouse)


def read_records(path):
    """The payloads of a TFRecord file, each length and data CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == ttb.masked_crc32c(header)
        payload = data[i + 12:i + 12 + length]
        assert struct.unpack("<I", data[i + 12 + length:i + 16 + length])[0] \
            == ttb.masked_crc32c(payload)
        out.append(payload)
        i += 16 + length
    return out


def test_crc32c_matches_jax():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb.masked_crc32c(data) == jtb.masked_crc32c(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value


def test_event_file_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    img = np.random.RandomState(0).randint(0, 256, (12, 20, 3), dtype=np.uint8)
    writers = {}
    for name, mod in (("jax", jtb), ("port", ttb)):
        w = mod.TBWriter(str(tmp_path / name))
        w.add_scalars({"Loss/G/loss": 1.5, "Loss/D/loss": -0.25,
                       "Progress/augment_p": float("nan"), "Progress/kimg": 4.0},
                      step=4000)
        w.add_scalar("Metrics/fd_proxy_real_fake", 12.5, 4000)
        w.add_image("fakes/sr", img, step=4000)
        w.close()
        writers[name] = w
    assert os.path.basename(writers["jax"].path) == os.path.basename(writers["port"].path)
    want, got = read_records(writers["jax"].path), read_records(writers["port"].path)
    assert len(got) == len(want) == 4
    assert got[:3] == want[:3]                      # header, scalars, scalar
    png = ttb.encode_png(img)
    assert got[3] == jtb._event(4000, jtb._summary_image("fakes/sr", png, 12, 20))
    assert got[3] != want[3]                        # Pillow's PNG bytes differ
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(io.BytesIO(png))), img)
    with open(writers["port"].path, "rb") as f:
        data = f.read()
    assert data[:12] == struct.pack("<Q", len(want[0])) + struct.pack(
        "<I", jtb.masked_crc32c(struct.pack("<Q", len(want[0]))))


def test_wandb_sink_is_a_no_op_without_the_package(tmp_path, monkeypatch):
    monkeypatch.delenv("PIX2PIX3D_WANDB", raising=False)
    sink = WandbSink(str(tmp_path))
    assert not sink.enabled
    sink.log_scalars({"a": 1.0}, step=0)
    sink.log_images("x", np.zeros((1, 2, 2, 3), np.uint8), 0)
    sink.finish()
    try:
        import wandb  # noqa: F401
        return
    except ImportError:
        pass
    monkeypatch.setenv("PIX2PIX3D_WANDB", "project")
    with pytest.warns(UserWarning, match="wandb package is not installed"):
        assert not WandbSink(str(tmp_path)).enabled


@pytest.mark.parametrize("n1,n2,dim", [(8, 8, 64), (5, 9, 2048), (40, 30, 16)])
def test_frechet_matches_jax(n1, n2, dim):
    rng = np.random.RandomState(n1 + n2 + dim)
    f1 = rng.randn(n1, dim).astype(np.float32)
    f2 = (rng.randn(n2, dim) * 1.3 + 0.2).astype(np.float32)
    want = jfid.frechet_lowrank(f1, f2)
    assert math.isclose(tfid.frechet_lowrank(f1, f2), want, rel_tol=1e-12)
    if dim > 64:   # the full covariances' eigendecompositions: small dims only
        return
    c1, c2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    assert math.isclose(tfid._sqrtm_product_trace(c1, c2),
                        jfid._sqrtm_product_trace(c1, c2), rel_tol=1e-12)
    m1, m2 = f1.mean(0), f2.mean(0)
    assert math.isclose(tfid.frechet_distance(m1, c1, m2, c2),
                        jfid.frechet_distance(m1, c1, m2, c2), rel_tol=1e-12)


def test_feature_stats_match_jax():
    rng = np.random.RandomState(1)
    chunks = [rng.randn(n, 12).astype(np.float32) for n in (5, 7, 9)]
    t = tmu.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=17)
    j = jmu.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=17)
    for c in chunks:
        t.append(c)
        j.append(c)
    assert t.num_items == j.num_items == 17 and t.is_full() and j.is_full()
    np.testing.assert_array_equal(t.get_all(), j.get_all())
    for a, b in zip(t.get_mean_cov(), j.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_proxy():
    return jmu.RandomConvFeatures()


def port_proxy(jax_proxy):
    return tmu.RandomConvFeatures(kernels=[np.asarray(k) for k in jax_proxy.kernels],
                                  proj=np.asarray(jax_proxy.proj), device="cpu")


@pytest.mark.parametrize("res", [32, 37])
def test_random_conv_features_on_jax_weights(jax_proxy, res):
    x = np.random.RandomState(res).randint(0, 256, (3, res, res, 3)).astype(np.float32)
    want = jax_proxy(x)
    got = port_proxy(jax_proxy)(x)
    assert got.shape == want.shape == (3, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_own_proxy_is_seeded_and_refuses_inception(monkeypatch):
    a = tmu.RandomConvFeatures(device="cpu")
    b = tmu.RandomConvFeatures(device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.kernels + [a.proj], b.kernels + [b.proj]))
    assert [tuple(k.shape) for k in a.kernels] == [(32, 3, 3, 3), (64, 32, 3, 3),
                                                   (128, 64, 3, 3), (256, 128, 3, 3)]
    # a variable that names no file leaves the proxy, as in the JAX package
    # (tests/test_torch_inception.py loads a file it names)
    monkeypatch.setenv("PIX2PIX3D_INCEPTION_NPZ", "/nonexistent.npz")
    assert isinstance(tmu.get_feature_extractor("cpu"), tmu.RandomConvFeatures)


def test_fd_trend_matches_jax_on_jax_weights(jax_proxy, monkeypatch):
    rng = np.random.RandomState(3)
    reals = rng.rand(4, 64, 64, 3).astype(np.float32) * 2 - 1
    fakes = [np.clip(reals + rng.randn(*reals.shape).astype(np.float32) * s, -1, 1)
             for s in (0.1, 0.6)]
    monkeypatch.setattr(jloop, "_FD_TREND_CACHE", {"detector": jax_proxy})
    cache = {"detector": port_proxy(jax_proxy)}
    got = [tloop.fd_trend_real_fake(reals, f, cache, "cpu") for f in fakes]
    want = [jloop._fd_trend_real_fake(reals, f) for f in fakes]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] < got[1] and set(cache) == {"detector", "real_feats"}
