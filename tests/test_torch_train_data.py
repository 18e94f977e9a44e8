"""The port's input pipeline and its Pillow-free PNG writer against the JAX
package's and Pillow: the PNG encoder (read back by Pillow), the native
decoder (built from `native/png_reader.cpp` into the port's `_build/`) on
Pillow's PNGs, the seg and edge datasets (directory and zip), the sampler
and the `DataLoader` batches, item for item against the JAX package's on
one synthetic folder; the training CLI's dry-run config against
`train.py`'s, and its refusal of inconsistent `--num-nodes` flags.
Exact equality throughout: the pipeline moves uint8
pixels and float32 poses, and normalizes them with the same arithmetic.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import io
import itertools
import json
import zipfile

import numpy as np
import PIL.Image
import pytest

from pix2pix3d_tpu.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                         pose_to_conditioning)
from pix2pix3d_tpu.train import dataset as jds

from pix2pix3d_tpu_torch.train import __main__ as tcli
from pix2pix3d_tpu_torch.train import dataset as tds
from pix2pix3d_tpu_torch.train import native_loader
from pix2pix3d_tpu_torch.utils.png import encode_png, write_png

from test_torch_train_phases import two_torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (9, 4, 3), (3, 6, 4), (64, 48, 3)])
def test_png_writer_against_pillow(shape):
    a = np.random.RandomState(sum(shape)).randint(0, 256, shape, dtype=np.uint8)
    got = np.array(PIL.Image.open(io.BytesIO(encode_png(a))))
    assert np.array_equal(got, a.reshape(got.shape))


def test_png_writer_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 2), np.uint8))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_native_decoder_on_pillow_pngs(mode):
    rng = np.random.RandomState(len(mode))
    a = rng.randint(0, 256, (33, 17, 3), dtype=np.uint8)
    img = PIL.Image.fromarray(a).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    got = native_loader.decode_png(buf.getvalue())
    want = np.array(img.convert("RGB") if mode == "P" else img)
    assert np.array_equal(got, want.reshape(got.shape))
    assert native_loader.library_path().parent.name == "_build"


def test_native_decoder_refuses_what_it_cannot_read():
    img = PIL.Image.fromarray(np.zeros((4, 4), np.uint16))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    with pytest.raises(ValueError, match="8-bit"):
        native_loader.decode_png(buf.getvalue())


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """16 128^2 RGB images, 6-class masks and edge maps (written with the
    port's encoder) and afhq poses in dataset.json."""
    root = tmp_path_factory.mktemp("traindata")
    dirs = {k: root / k for k in ("imgs", "masks", "edges")}
    for d in dirs.values():
        d.mkdir()
    rng = np.random.RandomState(0)
    labels = []
    for i in range(16):
        name = f"i{i:03d}.png"
        write_png(dirs["imgs"] / name, rng.randint(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(dirs["masks"] / name, rng.randint(0, 6, (128, 128), dtype=np.uint8))
        write_png(dirs["edges"] / name,
                  (rng.rand(64, 64, 3) > 0.8).astype(np.uint8) * 255)
        c2w = LookAtPoseSampler.sample(None, np.pi / 2 + 0.1 * i, np.pi / 2,
                                       [0, 0, -0.06], radius=2.7, batch_size=1)
        pose = np.asarray(pose_to_conditioning(c2w, fov_to_intrinsics(18.837)))[0]
        labels.append([name, [float(x) for x in pose]])
    with open(dirs["imgs"] / "dataset.json", "w") as f:
        json.dump({"labels": labels}, f)
    zpath = root / "imgs.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for p in sorted(dirs["imgs"].iterdir()):
            z.write(p, p.name)
    return {k: str(v) for k, v in dirs.items()} | {"zip": str(zpath)}


def _items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("kind", ["seg", "seg-zip", "seg-xflip", "edge"])
def test_datasets_match_jax(folder, kind):
    data = folder["zip"] if kind == "seg-zip" else folder["imgs"]
    data_type = "edge" if kind == "edge" else "seg"
    masks = folder["edges"] if kind == "edge" else folder["masks"]
    kw = dict(data_type=data_type, use_labels=True, xflip=kind == "seg-xflip")
    j = jds.build_dataset(data, masks, **kw)
    t = tds.build_dataset(data, masks, **kw)
    assert len(t) == len(j) and t.label_dim == j.label_dim == 25
    assert t.resolution == j.resolution == 128
    for i in (0, 5, len(t) - 1):
        _items_equal(t[i], j[i])
    np.testing.assert_array_equal(t.get_label_std(), j.get_label_std())
    t.close()
    j.close()


def test_sampler_and_loader_match_jax(folder):
    for kw in (dict(seed=3), dict(rank=1, num_replicas=2, seed=5)):
        a = list(itertools.islice(iter(tds.InfiniteSampler(16, **kw)), 40))
        b = list(itertools.islice(iter(jds.InfiniteSampler(16, **kw)), 40))
        assert a == b
    j = jds.build_dataset(folder["imgs"], folder["masks"], use_labels=True)
    t = tds.build_dataset(folder["imgs"], folder["masks"], use_labels=True)
    jl = jds.DataLoader(j, batch_size=4, seed=2)
    tl = tds.DataLoader(t, batch_size=4, seed=2)
    for _ in range(3):
        _items_equal(next(tl), next(jl))
    tl.close()


def test_loader_raises_the_workers_failure(folder, tmp_path):
    t = tds.build_dataset(folder["imgs"], folder["masks"], use_labels=True)
    t._image_fnames = t._image_fnames[:1] + ["missing.png"] * 15
    loader = tds.DataLoader(t, batch_size=16, seed=0)
    with pytest.raises(FileNotFoundError):
        next(loader)
    loader.close()


@pytest.mark.parametrize("flags,what", [
    (["--num-nodes", "2"], "--node-rank"),
    (["--num-nodes", "2", "--node-rank", "1"], "--coordinator"),
    (["--num-nodes", "2", "--node-rank", "2", "--coordinator", "localhost:1"],
     "node rank 2"),
    (["--num-nodes", "3", "--node-rank", "0", "--coordinator", "localhost:1"],
     "must divide over 3 devices"),
])
def test_cli_refuses_the_deferred_flags(folder, tmp_path, flags, what):
    """`--num-nodes` above 1 runs (multi-node training), but not without
    this node's rank and the coordinator, nor with a rank outside the
    world or a batch that does not divide over it: each is refused before
    anything is written."""
    argv = ["--outdir", str(tmp_path), "--cfg", "afhq", "--data", folder["imgs"],
            "--mask_data", folder["masks"], "--batch", "2", "--gamma", "5",
            "--device", "cpu"] + flags
    with pytest.raises(ValueError) as e:
        tcli.main(argv)
    assert what in str(e.value)
    assert not list(tmp_path.iterdir())


def _printed_config(out):
    """The run config a dry run prints (one JSON object of strings)."""
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.mark.parametrize("flags", [
    ["--aug", "ada"], ["--aug", "ada", "--target", "0.7"],
    ["--aug", "fixed"], ["--aug", "fixed", "--p", "0.35"],
    ["--sampler", "frustum"],
    ["--sampler", "frustum", "--frustum_depth_steps", "48", "--frustum_chunk",
     "4", "--frustum_bf16", "False"],
    ["--remat", "True"],
], ids=lambda f: " ".join(f))
def test_cli_dry_run_matches_train_py_for_each_flag(folder, tmp_path, monkeypatch,
                                                    capsys, flags):
    """`train.py -n` and the port's CLI with `-n` print the same run config
    (the port's adds the device) for each flag the port once refused."""
    import sys

    import train as jtrain
    argv = ["--outdir", str(tmp_path), "--cfg", "afhq", "--data", folder["imgs"],
            "--mask_data", folder["masks"], "--batch", "4", "--gamma", "5",
            "--semantic_channels", "6", "--dis_mask", "True", "-n"] + flags
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jtrain.main()
    want = _printed_config(capsys.readouterr().out)
    tcli.main(argv)
    got = _printed_config(capsys.readouterr().out)
    assert got.pop("device") == "cuda"
    assert got == want
    assert not list(tmp_path.iterdir())


def test_cli_dry_run_config_matches_train_py(folder, tmp_path):
    """The kwargs the port's CLI hands its training loop are train.py's for
    the seg2cat recipe, plus the device."""
    argv = ["--outdir", str(tmp_path), "--cfg", "afhq", "--data", folder["imgs"],
            "--mask_data", folder["masks"], "--data_type", "seg", "--batch", "4",
            "--gamma", "5", "--semantic_channels", "6", "--render_mask", "True",
            "--dis_mask", "True", "--neural_rendering_resolution_initial", "128",
            "--gen_pose_cond", "True", "--random_c_prob", "0.5",
            "--lambda_d_semantic", "0.1", "--lambda_lpips", "1",
            "--lambda_cross_view", "1e-4", "--only_raw_recons", "True"]
    cfg = tcli.run_config(tcli.parser().parse_args(argv))
    assert cfg.pop("device") == "cuda"
    assert cfg["loss_kwargs"] == dict(
        r1_gamma=5.0, blur_init_sigma=10, blur_fade_kimg=25.0,
        neural_rendering_resolution_initial=128,
        neural_rendering_resolution_final=None,
        neural_rendering_resolution_fade_kimg=1000, gpc_reg_prob=0.5,
        gpc_reg_fade_kimg=1000, dual_discrimination=True, random_c_prob=0.5,
        lambda_l1=0.0, lambda_lpips=1.0, lambda_D_semantic=0.1, seg_weight=0.0,
        edge_weight=2.0, only_raw_recons=True, silhouette_loss=False,
        lambda_cross_view=1e-4, remat=False)
    assert cfg["d_kwargs"] == dict(channel_base=32768, channel_max=512,
                                   num_fp16_res=4, conv_clamp=256, disc_c_noise=0.0,
                                   epilogue_kwargs=dict(mbstd_group_size=4))
    assert cfg["g_reg_interval"] == 4 and cfg["use_d_semantic"] is True
    assert cfg["g_config"]["rendering_kwargs"]["reg_type"] == "l1"
    assert cfg["g_config"]["sr_num_fp16_res"] == 4
    assert tcli.main(argv + ["-n"]).startswith(str(tmp_path))
