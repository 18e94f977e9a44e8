"""The port's Inception-v3 (`pix2pix3d_tpu_torch/metrics/inception.py`)
against the JAX package's on one npz of random weights in the layout of
scripts/convert_inception.py, batch 2, on the CPU.

- Features `[2, 2048]` and logits `[2, 1000]` at 64² and 512² inputs (an
  upsampling and an antialiased downsampling to 299²): within 1e-4 of the
  largest |value|.  Both sides run f32; 94 convolutions and BatchNorms sum
  in other orders (measured 1.7e-6 of the largest feature).
- The shape table is torchvision's `inception_v3` with its auxiliary
  classifier: 96 convolutions, and 27,161,264 parameters, torchvision's
  published count for its ImageNet weights.  A file with a missing key or a
  wrong shape is refused.
- `get_feature_extractor` returns the port's Inception when
  `PIX2PIX3D_INCEPTION_NPZ` names a file, and the random-convolution proxy
  when it names none, as the JAX package's does.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

from pix2pix3d_tpu.metrics import metric_utils as jmu
from pix2pix3d_tpu.metrics.inception import InceptionV3Features as JInception

from pix2pix3d_tpu_torch.metrics import inception as ti
from pix2pix3d_tpu_torch.metrics import metric_utils as tmu

from test_torch_train_phases import two_torch_threads

__all__ = ["two_torch_threads"]

TOL = 1e-4


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "inception_v3.npz"
    np.savez(path, **ti.random_inception_weights(0))
    return str(path)


@pytest.fixture(scope="module")
def networks(weights):
    return JInception(weights), ti.InceptionV3Features(weights, device="cpu")


@pytest.mark.parametrize("res", [64, 512])
def test_features_and_logits_match_jax(networks, res):
    jnet, tnet = networks
    x = np.random.RandomState(res).randint(0, 256, (2, res, res, 3)).astype(np.float32)
    for name in ("__call__", "logits"):
        want = getattr(jnet, name)(x)
        got = getattr(tnet, name)(torch.from_numpy(x))
        assert got.shape == want.shape == (2, 2048 if name == "__call__" else 1000)
        assert np.isfinite(got).all() and np.abs(want).max() > 0.1
        assert np.abs(got - want).max() <= TOL * np.abs(want).max(), name


def test_shape_table_is_torchvisions():
    shapes = ti.INCEPTION_SHAPES
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    n_params = sum(int(np.prod(s)) for k, s in shapes.items()
                   if not k.endswith(buffers))
    assert n_params == 27161264
    assert len(ti.CONVS) == 96 and sum(k.endswith("conv/weight") for k in shapes) == 96
    assert shapes["fc/weight"] == (1000, 2048)
    assert shapes["Mixed_6b/branch7x7_2/conv/weight"] == (1, 7, 128, 128)


def test_refuses_a_file_of_other_keys_or_shapes(tmp_path):
    w = ti.random_inception_weights(0)
    bad = dict(w)
    del bad["Mixed_7c/branch_pool/bn/running_var"]
    bad["fc/weight"] = bad["fc/weight"].T
    path = tmp_path / "bad.npz"
    np.savez(path, **bad)
    with pytest.raises(ValueError, match=r"missing \['Mixed_7c/branch_pool/bn/"
                                         r"running_var'\].*fc/weight \(2048, 1000\)"):
        ti.InceptionV3Features(str(path), device="cpu")


def test_get_feature_extractor_loads_inception(weights, monkeypatch):
    monkeypatch.setenv("PIX2PIX3D_INCEPTION_NPZ", weights)
    det = tmu.get_feature_extractor("cpu")
    assert isinstance(det, ti.InceptionV3Features)
    assert isinstance(jmu.get_feature_extractor(), JInception)
    # a name of no file: the proxy in both (JAX's stood in for by a stub,
    # whose construction draws nothing)
    monkeypatch.setenv("PIX2PIX3D_INCEPTION_NPZ", weights + ".missing")
    monkeypatch.setattr(jmu, "RandomConvFeatures", lambda: "jax proxy")
    assert isinstance(tmu.get_feature_extractor("cpu"), tmu.RandomConvFeatures)
    assert jmu.get_feature_extractor() == "jax proxy"


def test_inception_defaults_to_the_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ti.InceptionV3Features(weights)
