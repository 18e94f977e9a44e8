"""The port's metrics package (`pix2pix3d_tpu_torch/metrics/`) and
`utils/profiling.py` against the JAX package's, on the CPU, without a
generator or a network to compile.

- The numpy math (confusion matrix, mIoU, KID, precision/recall's radii and
  fractions) on the same f64 inputs: equal to 1e-12 (the same arithmetic;
  the port's radii come from `torch.cdist` on differences, other summation
  orders).
- The registry: the same names in the same order; the equivariance names
  pass JAX's arguments and run on a small StyleGAN3 generator.
- The metric loops (`iterate_real_features`, `iterate_gen_features` on seg
  and edge data, `compute_miou`, `calc_metric("miou500")`, `compute_fid`,
  `compute_kid`, `compute_pr`, `compute_is`, `compute_ppl`) in both
  packages on a stub generator: a plain callable with each package's call
  shape whose outputs are one numpy function of z, mask and pose, and a
  numpy stub detector.  JAX's z and t draws are recorded and handed to the
  port's draw hooks.  Equal inputs and the same numpy arithmetic give equal
  values: equality is asserted, but for PPL, whose distance is each
  package's own LPIPS network (on one set of weights): there, 1e-3
  relative (f32 convolutions summed in other orders, on two images 1e-4
  apart in W, divided by 1e-8; measured 6.4e-5).
- `PhaseTimer`, `annotate` and `trace` of the port's profiling helpers
  (`annotate` off and on, `host_read` and the render's spans:
  tests/test_torch_profiling.py).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import contextlib
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.metrics import frechet_inception_distance as jfid
from pix2pix3d_tpu.metrics import inception_score as jis
from pix2pix3d_tpu.metrics import kernel_inception_distance as jkid
from pix2pix3d_tpu.metrics import metric_main as jmain
from pix2pix3d_tpu.metrics import metric_utils as jmu
from pix2pix3d_tpu.metrics import miou as jmiou
from pix2pix3d_tpu.metrics import perceptual_path_length as jppl
from pix2pix3d_tpu.metrics import precision_recall as jpr

from pix2pix3d_tpu_torch.metrics import frechet_inception_distance as tfid
from pix2pix3d_tpu_torch.metrics import inception_score as tis
from pix2pix3d_tpu_torch.metrics import kernel_inception_distance as tkid
from pix2pix3d_tpu_torch.metrics import metric_main as tmain
from pix2pix3d_tpu_torch.metrics import metric_utils as tmu
from pix2pix3d_tpu_torch.metrics import miou as tmiou
from pix2pix3d_tpu_torch.metrics import perceptual_path_length as tppl
from pix2pix3d_tpu_torch.metrics import precision_recall as tpr
from pix2pix3d_tpu_torch.train.lpips import LPIPS as TLPIPS
from pix2pix3d_tpu_torch.utils import profiling

from test_torch_train_phases import two_torch_threads

__all__ = ["two_torch_threads"]

Z_DIM, CLASSES, RES, DATA_RES, ITEMS = 16, 4, 16, 32, 10


# --- the numpy math ---------------------------------------------------------

def test_confusion_matrix_and_miou_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 5, (3, 7, 9))
    target = rng.randint(0, 5, (3, 7, 9))
    want = jmiou.confusion_matrix(pred, target, 5)
    np.testing.assert_array_equal(tmiou.confusion_matrix(pred, target, 5), want)
    got = tmiou.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), 5)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    cm = want.copy()
    cm[4] = cm[:, 4] = 0      # a class absent from both: left out of the mean
    assert tmiou.miou_from_confusion(cm) == jmiou.miou_from_confusion(cm)
    assert tmiou.miou_from_confusion(want) == jmiou.miou_from_confusion(want)


@pytest.mark.parametrize("subset", [200, 1000])
def test_kid_from_features_matches_jax(subset):
    rng = np.random.RandomState(1)
    real = rng.randn(300, 24)
    gen = rng.randn(260, 24) * 1.2 + 0.3
    want = jkid.kid_from_features(real, gen, num_subsets=20, max_subset_size=subset)
    got = tkid.kid_from_features(real, gen, num_subsets=20, max_subset_size=subset)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("k", [1, 3])
def test_precision_recall_radii_and_fractions_match_jax(k):
    rng = np.random.RandomState(2)
    real = rng.randn(70, 32)
    gen = rng.randn(50, 32) * 1.1 + 0.1
    want = jpr._knn_radii(real, k)
    # blocks of 11 rows: several blocks and a ragged last one
    got = tpr._knn_radii(torch.from_numpy(real), k, batch=11)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    for q, s, r in ((gen, real, want), (real, gen, jpr._knn_radii(gen, k))):
        assert tpr._fraction_in_manifold(
            torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(r),
            batch=7) == jpr._fraction_in_manifold(q, s, r)


# --- the registry -------------------------------------------------------------

def test_registry_matches_jax_and_refuses_equivariance(monkeypatch):
    """The registry: JAX's names in JAX's order.  The equivariance names run
    `compute_equivariance_metrics` with JAX's arguments, on a small
    `GeneratorS3` here with num_samples capped at 8 (their 50000 and 100
    samples are the card's), and return JAX's keys.  The test keeps the
    name it had when the port refused these four."""
    assert tmain.list_valid_metrics() == jmain.list_valid_metrics()
    assert all(tmain.is_valid_metric(m) for m in jmain.list_valid_metrics())
    assert not tmain.is_valid_metric("fid10k")
    from pix2pix3d_tpu.metrics import equivariance as jeq
    from pix2pix3d_tpu_torch.nn.stylegan3 import GeneratorS3
    from pix2pix3d_tpu_torch.models.triplane import init_parameters

    G = GeneratorS3(z_dim=8, c_dim=0, w_dim=8, img_resolution=16, img_channels=3,
                    channel_base=256, channel_max=16, num_layers=4,
                    mapping_kwargs=dict(num_layers=1))
    init_parameters(G, torch.Generator().manual_seed(0))
    calls = {"jax": [], "port": []}
    real = tmain.compute_equivariance_metrics

    def jax_args(opts, **kw):
        calls["jax"].append(kw)
        return {k: 0.0 for k in ("eqt_int", "eqt_frac", "eqr")}

    def capped(opts, **kw):
        calls["port"].append(dict(kw))
        kw["num_samples"] = 8
        return real(opts, **kw)

    monkeypatch.setattr(jeq, "compute_equivariance_metrics", jax_args)
    monkeypatch.setattr(tmain, "compute_equivariance_metrics", capped)
    for name in ("eqt50k_int", "eqt50k_frac", "eqr50k", "eq100"):
        want = jmain.calc_metric(name)["results"]
        got = tmain.calc_metric(name, G=G, device="cpu")["results"]
        assert set(got) == set(want), name
        assert all(np.isfinite(v) for v in got.values()), (name, got)
    assert calls["port"] == calls["jax"]


def test_metric_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmu.MetricOptions()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.calc_metric("miou500")


# --- a stub generator, dataset and detector -----------------------------------

class _Core:
    """The stub generator's numpy function of (z, mask, pose)."""

    def __init__(self):
        rng = np.random.RandomState(7)
        self.a = rng.randn(Z_DIM, 8).astype(np.float32) / 4
        self.p = rng.randn(25, 8).astype(np.float32) / 4
        self.img = rng.randn(8, RES * RES * 3).astype(np.float32) / 3
        self.sem = rng.randn(8, RES * RES * CLASSES).astype(np.float32)

    def mapping(self, z, mask, pose):
        w = np.tanh(z @ self.a + pose @ self.p + mask.mean(axis=(1, 2, 3))[:, None] / 10)
        return np.repeat(w[:, None], 2, axis=1).astype(np.float32)

    def synthesis(self, ws):
        w = ws.mean(axis=1)
        image = np.tanh(w @ self.img).reshape(-1, RES, RES, 3)
        return image.astype(np.float32), (w @ self.sem).reshape(-1, RES, RES, CLASSES)

    def forward(self, z, mask, pose):
        image, sem = self.synthesis(self.mapping(z, mask, pose))
        step = DATA_RES // RES
        labels = np.clip(mask[:, ::step, ::step, 0], 0, CLASSES - 1).astype(np.int64)
        sem = sem + 2 * np.eye(CLASSES, dtype=np.float32)[labels]
        return image, sem.astype(np.float32)


CORE = _Core()


class JaxStub:
    """The JAX package's call shape: G(params, z, c, batch, ...)."""
    z_dim, semantic_channels = Z_DIM, CLASSES

    def __init__(self):
        self.calls = 0

    def __call__(self, params, z, c, batch, noise_mode="random", det=False):
        assert (noise_mode, det) == ("const", True)
        self.calls += 1
        image, sem = CORE.forward(*(np.asarray(a) for a in (z, batch["mask"], batch["pose"])))
        return {"image": jnp.asarray(image), "semantic": jnp.asarray(sem)}

    def mapping(self, params, z, c, batch):
        return jnp.asarray(CORE.mapping(*(np.asarray(a) for a in (z, batch["mask"], c))))

    def synthesis(self, params, ws, c, noise_mode="random", det=False):
        assert (noise_mode, det) == ("const", True)
        return {"image": jnp.asarray(CORE.synthesis(np.asarray(ws))[0])}


def _np(t):
    return t.cpu().numpy()


class PortStub(torch.nn.Module):
    """The port's call shape: G(z, c, batch, ...), tensors in and out."""
    z_dim, semantic_channels = Z_DIM, CLASSES

    def forward(self, z, c, batch, noise_mode="random", det=False):
        assert (noise_mode, det) == ("const", True)
        image, sem = CORE.forward(_np(z), _np(batch["mask"]), _np(batch["pose"]))
        return {"image": torch.from_numpy(image), "semantic": torch.from_numpy(sem)}

    def mapping(self, z, c, batch):
        return torch.from_numpy(CORE.mapping(_np(z), _np(batch["mask"]), _np(c)))

    def synthesis(self, ws, c, noise_mode="random", det=False):
        assert (noise_mode, det) == ("const", True)
        return {"image": torch.from_numpy(CORE.synthesis(_np(ws))[0])}


class Folder:
    """A dataset of `ITEMS` seeded items: uint8 images, label or edge
    masks, poses."""

    def __init__(self, data_type):
        rng = np.random.RandomState(3)
        self.data_type = data_type
        self.images = rng.randint(0, 256, (ITEMS, DATA_RES, DATA_RES, 3)).astype(np.uint8)
        shape = (ITEMS, DATA_RES, DATA_RES, 1)
        self.masks = (rng.randint(0, CLASSES, shape) if data_type == "seg"
                      else (rng.rand(*shape) > 0.8) * 255).astype(np.uint8)
        self.poses = rng.randn(ITEMS, 25).astype(np.float32)

    def __len__(self):
        return ITEMS

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i], "pose": self.poses[i],
                "idx": i}


class Detector:
    """A numpy feature detector: 8x8 means of the image, projected to 24
    features; logits, a projection of those."""

    def __init__(self):
        rng = np.random.RandomState(11)
        self.proj = rng.randn(8 * 8 * 3, 24).astype(np.float32) / 50
        self.head = rng.randn(24, 10).astype(np.float32) / 30

    def __call__(self, images):
        x = np.asarray(_np(images) if isinstance(images, torch.Tensor) else images,
                       np.float32)
        n, h, w, _ = x.shape
        x = x.reshape(n, 8, h // 8, 8, w // 8, 3).mean(axis=(2, 4)).reshape(n, -1)
        return x @ self.proj

    def logits(self, images):
        return self(images) @ self.head


_JAX_DRAWS = {"normal": jax.random.normal, "uniform": jax.random.uniform}


@pytest.fixture
def shared_draws(monkeypatch):
    """`record()` is a context that records JAX's normal and uniform draws;
    the port's `draw_normal`/`draw_uniform` hooks then hand them out in
    order, each checking the kind and shape it asks for."""
    queue = []

    @contextlib.contextmanager
    def record():
        def wrap(kind):
            def draw(*args, **kwargs):
                value = _JAX_DRAWS[kind](*args, **kwargs)
                queue.append((kind, np.asarray(value)))
                return value
            return draw
        for kind in _JAX_DRAWS:
            monkeypatch.setattr(jax.random, kind, wrap(kind))
        try:
            yield queue
        finally:
            for kind, fn in _JAX_DRAWS.items():
                monkeypatch.setattr(jax.random, kind, fn)

    def take(kind, shape):
        assert queue, f"the port drew more than the JAX package ({kind} {shape})"
        got_kind, arr = queue.pop(0)
        assert got_kind == kind and arr.shape == tuple(shape), (kind, shape, got_kind, arr.shape)
        return torch.from_numpy(arr.copy())

    monkeypatch.setattr(tmu, "draw_normal", lambda g, shape: take("normal", shape))
    monkeypatch.setattr(tmu, "draw_uniform", lambda g, shape: take("uniform", shape))
    yield record
    assert not queue, f"the port drew {len(queue)} fewer numbers than JAX"


@pytest.fixture
def detectors(monkeypatch):
    """The stub detector in both packages' `get_feature_extractor`."""
    det = Detector()
    for module in (jfid, jkid, jpr, jis):
        monkeypatch.setattr(module, "get_feature_extractor", lambda: det)
    monkeypatch.setattr(tmu, "get_feature_extractor", lambda device: det)
    return det


def _both(shared_draws, data_type, jax_fn, port_fn, rng_seed=5):
    """(JAX's result, the port's) of `fn(opts)` on the stubs, the port on
    JAX's draws."""
    ds = Folder(data_type)
    with shared_draws():
        want = jax_fn(jmu.MetricOptions(G=JaxStub(), dataset=ds, rng_seed=rng_seed))
    got = port_fn(tmu.MetricOptions(G=PortStub(), dataset=ds, rng_seed=rng_seed,
                                    device="cpu"))
    return want, got


def test_iterate_real_features_matches_jax():
    ds = Folder("seg")
    det = Detector()
    want = jmu.iterate_real_features(jmu.MetricOptions(dataset=ds), det, batch_size=4,
                                     max_items=9)
    got = tmu.iterate_real_features(tmu.MetricOptions(dataset=ds, device="cpu"), det,
                                    batch_size=4, max_items=9)
    assert got.num_items == want.num_items == 9
    np.testing.assert_array_equal(got.get_all(), want.get_all())


@pytest.mark.parametrize("data_type", ["seg", "edge"])
def test_iterate_gen_features_matches_jax(shared_draws, data_type):
    det = Detector()
    want, got = _both(shared_draws, data_type,
                      lambda o: jmu.iterate_gen_features(o, det, batch_size=4, max_items=10),
                      lambda o: tmu.iterate_gen_features(o, det, batch_size=4, max_items=10))
    assert got.num_items == want.num_items == 10
    np.testing.assert_array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


def test_compute_miou_matches_jax(shared_draws):
    want, got = _both(shared_draws, "seg",
                      lambda o: jmiou.compute_miou(o, num_items=20, batch_size=8),
                      lambda o: tmiou.compute_miou(o, num_items=20, batch_size=8))
    assert got == want
    assert 0 < got["miou"] < 1 and 0 < got["pixel_acc"] < 1


def test_calc_metric_miou500_matches_jax(shared_draws):
    ds = Folder("seg")
    G = JaxStub()
    with shared_draws():
        want = jmain.calc_metric("miou500", G=G, G_params=None, dataset=ds)
    got = tmain.calc_metric("miou500", G=PortStub(), G_params=None, dataset=ds,
                            device="cpu")
    assert G.calls == 63      # 500 items at batch 8
    assert got["metric"] == want["metric"] == "miou500"
    assert got["results"] == want["results"]
    assert got["total_time"] > 0


def test_compute_fid_kid_pr_match_jax(shared_draws, detectors):
    for jfn, tfn in ((jfid.compute_fid, tfid.compute_fid),
                     (jkid.compute_kid, tkid.compute_kid),
                     (jpr.compute_pr, tpr.compute_pr)):
        want, got = _both(shared_draws, "seg",
                          lambda o: jfn(o, max_real=ITEMS, num_gen=16),
                          lambda o: tfn(o, max_real=ITEMS, num_gen=16))
        assert got == want, jfn.__module__
    assert 0 < got["precision"] <= 1 and 0 < got["recall"] <= 1


def test_compute_is_matches_jax(shared_draws, detectors):
    want, got = _both(shared_draws, "seg",
                      lambda o: jis.compute_is(o, num_gen=16, num_splits=2),
                      lambda o: tis.compute_is(o, num_gen=16, num_splits=2))
    assert got == want and got[0] > 1


def test_compute_is_refuses_the_proxy(monkeypatch):
    monkeypatch.delenv("PIX2PIX3D_INCEPTION_NPZ", raising=False)
    opts = tmu.MetricOptions(G=PortStub(), dataset=Folder("seg"), device="cpu")
    with pytest.raises(RuntimeError, match="classifier logits"):
        tis.compute_is(opts, num_gen=8)


def test_compute_ppl_matches_jax(shared_draws, tmp_path):
    # the port's seeded random VGG, in the JAX module's layout (HWIO), for both
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **{k: v.numpy().transpose(2, 3, 1, 0) if v.ndim == 4 else v.numpy()
                      for k, v in TLPIPS().state_dict().items()})
    want, got = _both(shared_draws, "edge",
                      lambda o: jppl.compute_ppl(o, num_samples=4, batch_size=4,
                                                 lpips_weights=path),
                      lambda o: tppl.compute_ppl(o, num_samples=4, batch_size=4,
                                                 lpips_weights=path))
    assert got == pytest.approx(want, rel=1e-3) and want > 0


# --- utils/profiling.py ---------------------------------------------------------

def test_phase_timer_and_annotations(tmp_path):
    timer = profiling.PhaseTimer()
    x = torch.ones(8)
    for _ in range(3):
        with timer.tick("gen", block_on=x):
            x = x * 2
    with timer.tick("feat", block_on={"a": [x, "cpu"]}):
        pass
    assert timer.counts == {"gen": 3, "feat": 1}
    means = timer.means_ms()
    assert set(means) == {"gen", "feat"} and all(v >= 0 for v in means.values())
    assert means["gen"] == pytest.approx(1e3 * timer.totals["gen"] / 3)

    with profiling.trace(tmp_path / "tb") as prof:
        with profiling.annotate("metric_phase"):
            x * 3
    names = {e.key for e in prof.key_averages()}
    assert "metric_phase" in names
    traces = glob.glob(os.path.join(tmp_path, "tb", "*.pt.trace.json"))
    assert len(traces) == 1 and "metric_phase" in open(traces[0]).read()
