"""The training loop's spans and its shared step path (`train/loop.py`
`StepInputs` and `run_step`, `parallel/trainer.py`'s stats read):

- the `train.data` span (the batch fetch and its copy to the device) and the
  `sync.stats` read (`utils/profiling.host_read`) appear under a profiler
  and open no range without one;
- one step makes exactly one counted host read, `sync.stats`;
- `training_loop`, stepped through the shared path, gives the inputs and the
  state that the loop's former inline body gave, bit for bit.

Port only, on the CPU, at a tiny width: nothing here compares with JAX.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                               pose_to_conditioning)
from pix2pix3d_tpu_torch.train import loop as tloop
from pix2pix3d_tpu_torch.train.dataset import DataLoader, build_dataset
from pix2pix3d_tpu_torch.parallel.trainer import Trainer
from pix2pix3d_tpu_torch.utils import profiling
from pix2pix3d_tpu_torch.utils.png import write_png

RES, NRR, B, SEED = 128, 16, 4, 3
D_KW = dict(channel_base=512, channel_max=16, num_fp16_res=0,
            epilogue_kwargs={"mbstd_group_size": 2})
LOSS_KW = dict(r1_gamma=5.0, random_c_prob=0.5, lambda_l1=1.0, lambda_lpips=1.0,
               blur_init_sigma=10, blur_fade_kimg=25, lambda_D_semantic=0.1,
               only_raw_recons=True, lambda_cross_view=1e-4,
               neural_rendering_resolution_initial=NRR)
STEP_KW = dict(batch_size=B, ema_kimg=B * 10 / 32, ema_rampup=0.05, aug_p=0.0)


def tiny_g_config():
    cfg = tconfig.generator_config(cfg="afhq", resolution=RES, data_type="seg",
                                   semantic_channels=6, cbase=512, cmax=16,
                                   sr_num_fp16_res=0, render_mask=True,
                                   gen_pose_cond=True)
    cfg["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4)
    cfg["mapping_kwargs"]["in_resolution"] = RES
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    return cfg


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """8 RGB images, 6-class masks and afhq poses, as the loader reads them."""
    root = tmp_path_factory.mktemp("spans_data")
    imgs, masks = root / "imgs", root / "masks"
    imgs.mkdir()
    masks.mkdir()
    rng = np.random.RandomState(0)
    labels = []
    intr = fov_to_intrinsics(18.837, device="cpu")
    for i in range(8):
        name = f"i{i:03d}.png"
        write_png(imgs / name, rng.randint(0, 256, (RES, RES, 3), dtype=np.uint8))
        write_png(masks / name, rng.randint(0, 6, (RES, RES), dtype=np.uint8))
        c2w = LookAtPoseSampler.sample(np.pi / 2 + 0.1 * i, np.pi / 2, [0, 0, -0.06],
                                       radius=2.7, batch_size=1, device="cpu")
        labels.append([name, [float(x) for x in pose_to_conditioning(c2w, intr)[0]]])
    (imgs / "dataset.json").write_text(json.dumps({"labels": labels}))
    return {"path": str(imgs), "mask_path": str(masks), "data_type": "seg",
            "use_labels": True}


def _built(folder):
    """The loop's pieces at world size 1, built as `training_loop` builds
    them (the snapshot grid's batch taken first)."""
    dataset = build_dataset(**folder)
    loader = DataLoader(dataset, batch_size=B, seed=SEED, rows=(0, B), full_first=True)
    trainer = tloop.build_training(tiny_g_config(), dataset.label_dim, d_kwargs=D_KW,
                                   loss_kwargs=LOSS_KW, random_seed=SEED, device="cpu")
    next(loader)
    return dataset, loader, trainer


@pytest.fixture(scope="module")
def built(folder):
    dataset, loader, trainer = _built(folder)
    inputs = tloop.StepInputs(dataset, loader, B, (0, B), trainer.G.z_dim, SEED, "cpu")
    yield trainer, inputs
    loader.close()


def _step(trainer, inputs, k):
    return tloop.run_step(trainer, inputs, step_idx=k, cur_nimg=k * B, **STEP_KW)


def test_spans_under_a_profiler_and_none_without(built, monkeypatch):
    trainer, inputs = built

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with precision_off():
        stats = _step(trainer, inputs, 1)
    assert stats and all(v.dtype == np.float32 and v.shape == (3,) for v in stats.values())
    monkeypatch.undo()
    with precision_off(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(trainer, inputs, 2)
    names = [e.name for e in prof.events()]
    assert names.count("train.data") == 1
    assert names.count("sync.stats") == 1


@pytest.mark.parametrize("k", [4, 5])        # with Greg, without
def test_one_counted_host_read_per_step(built, k):
    trainer, inputs = built
    with precision_off(), profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = _step(trainer, inputs, k)
    syncs = [e.name for e in prof.events() if e.name.startswith("sync.")]
    assert syncs == ["sync.stats"]
    assert "Loss/G/loss" in stats and np.all(np.isfinite(np.stack(list(stats.values()))))


def precision_off():
    from pix2pix3d_tpu_torch.ops import precision
    return precision.policy(False)


def _former_loop_inputs(dataset, loader, z_dim, steps):
    """The inputs of `steps` steps as the loop's inline body drew them
    before `StepInputs` (world size 1: rows [0, B))."""
    shared = torch.Generator().manual_seed(SEED * 1000 + 7)
    pose_rng = np.random.RandomState(SEED)
    for _ in range(steps):
        batch = tloop.to_device(next(loader), torch.device("cpu"))
        gen_z = torch.randn((4, B, z_dim), generator=shared)[:, 0:B]
        gen_idx = pose_rng.randint(len(dataset), size=4 * B)
        gen_c = torch.from_numpy(np.stack(
            [dataset.get_label(i) for i in gen_idx.reshape(4, B)[:, 0:B].reshape(-1)])
            .reshape(4, B, -1).astype(np.float32))
        yield batch, gen_z, gen_c, shared


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_the_loop_steps_as_its_former_body(folder, tmp_path):
    steps = 2
    seen = []

    def record(trainer, batch, gen_z, gen_c, generator, **kw):
        seen.append(({k: v.clone() for k, v in batch.items()}, gen_z.clone(),
                     gen_c.clone(), generator.get_state().clone(), kw))
        return Trainer.step(trainer, batch, gen_z, gen_c, generator, **kw)

    got = tloop.training_loop(
        run_dir=str(tmp_path / "run"), dataset_kwargs=folder, g_config=tiny_g_config(),
        d_kwargs=D_KW, loss_kwargs=LOSS_KW, batch_size=B, total_kimg=steps * B / 1000,
        kimg_per_tick=1, snapshot_ticks=None, image_snapshot_ticks=None,
        random_seed=SEED, device="cpu", step_fn=record)

    dataset, loader, want = _built(folder)
    try:
        with precision_off():
            for k, (batch, gen_z, gen_c, gen) in enumerate(
                    _former_loop_inputs(dataset, loader, want.G.z_dim, steps)):
                b, z, c, state, kw = seen[k]
                assert kw == dict(step_idx=k, cur_nimg=k * B, **STEP_KW)
                for key in batch:
                    assert torch.equal(batch[key], b[key]), key
                assert torch.equal(gen_z, z) and torch.equal(gen_c, c)
                assert torch.equal(gen.get_state(), state)
                Trainer.step(want, batch, gen_z, gen_c, gen, step_idx=k, cur_nimg=k * B,
                             **STEP_KW)
    finally:
        loader.close()
    a, b = dict(_leaves(got.state_tree())), dict(_leaves(want.state_tree()))
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key
