"""The new generators through the port's entry points, on the CPU: one step
of `python -m pix2pix3d_tpu_torch.train` with train.py's defaults (the
conditional EG3D `TriPlaneGenerator`, no D_semantic) and one with `--use_bg
True --silhouette_loss True`, each checkpoint read by the JAX package;
and each new generator's weights through checkpoints both ways (the port
writes, the JAX package reads; the JAX package writes, the port's
`build_app_generator` builds the class its sidecar names) and through the
reference-pickle converter.

Every comparison is exact: checkpoints carry bits.  The training runs use
tests/test_torch_train_data.py's folder (128² images, 6-class masks) at
cbase 512, cmax 16, encoder channel base 1/128, nrr 16, batch 2, one step.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.train import checkpoint as jckpt

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.apps.common import build_app_generator
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.train import __main__ as tcli
from pix2pix3d_tpu_torch.train import checkpoint as tckpt
from pix2pix3d_tpu_torch.utils import convert as tconvert
from pix2pix3d_tpu_torch.utils.misc import tree_paths

from test_torch_train_data import folder  # noqa: F401  (fixture)
from test_torch_train_phases import two_torch_threads
from test_torch_variants_generators import small_cfg

__all__ = ["two_torch_threads"]

SMALL = ["--cbase", "512", "--cmax", "16", "--mbstd-group", "2", "--batch", "2",
         "--gamma", "5", "--semantic_channels", "6",
         "--neural_rendering_resolution_initial", "16", "--kimg", "0.002",
         "--tick", "0.002", "--snap", "1", "--device", "cpu"]


def _leaves(tree):
    return {k: np.asarray(v) for k, v in tree_paths(tree)}


def assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """The runs' directory, removed after the test; the CLI's generator with
    the mapping's encoder narrowed as every small configuration of these
    tests narrows it (encoder channel base 1/128: the CLI has no flag for
    it, and at full width it costs ~3 s a forward on the CPU and ~1.7 GB of
    checkpoints a run)."""
    build = tcli.cfg_mod.generator_config

    def narrowed(**kw):
        cfg = build(**kw)
        cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
        return cfg
    monkeypatch.setattr(tcli.cfg_mod, "generator_config", narrowed)
    path = tmp_path / "runs"
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _train(folder, runs, flags):  # noqa: F811
    argv = (["--outdir", str(runs), "--cfg", "afhq", "--data",
             folder["imgs"], "--mask_data", folder["masks"]] + SMALL + flags)
    run_dir = tcli.main(argv)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        stats = json.loads(f.readline())
    return run_dir, stats


def _jax_reads(path):
    """The checkpoint as the JAX package reads it, equal to the port's
    reading; its sidecar's g_config."""
    with open(path + ".json") as f:
        g_config = json.load(f)["g_config"]
    state, step = jckpt.load_checkpoint(path)
    port, _ = tckpt.load_checkpoint(path)
    assert_trees_equal(jax.device_get(state), port)
    return g_config, state, step


def test_cli_trains_with_train_py_defaults(folder, runs, capsys):  # noqa: F811
    """No --render_mask / --dis_mask: TriPlaneGenerator without D_semantic.
    Its snapshot fails loudly at the seg label grid and the run goes on to
    the checkpoints, as the JAX loop does (`train/loop.py:307-315` there)."""
    run_dir, stats = _train(folder, runs, [])
    out = capsys.readouterr().out
    assert "image snapshot FAILED (continuing to checkpoint save): KeyError: " \
           "'semantic'" in out
    assert "fd trend skipped: no fakes rendered this tick" in out
    for k in ("Loss/G/loss", "Loss/D/loss", "Loss/D/reg",
              "Loss/G/loss_img_reconstruction"):
        assert np.isfinite(stats[k]), k
    assert not any("semantic" in k or "silhouette" in k for k in stats), stats
    files = set(os.listdir(run_dir))
    assert {"network-snapshot-000000.ckpt", "network-final.ckpt",
            "fakes000000.png"} <= files
    assert "quality.jsonl" not in files
    g_config, state, step = _jax_reads(os.path.join(run_dir, "network-final.ckpt"))
    assert g_config["class_name"] == "TriPlaneGenerator" and step == 2
    assert "D_semantic" not in state
    assert "decoder" in state["G"] and "superresolution_semantic" not in state["G"]


def test_cli_trains_the_background_generator(folder, runs):  # noqa: F811
    run_dir, stats = _train(folder, runs, [
        "--render_mask", "True", "--dis_mask", "True", "--use_bg", "True",
        "--silhouette_loss", "True"])
    for k in ("Loss/G/loss", "Loss/G/loss_silhouette", "Loss/D/loss",
              "Loss/D/loss_semantic", "Loss/D/reg_semantic"):
        assert np.isfinite(stats[k]), k
    assert stats["Loss/G/loss_silhouette"] > 0
    files = set(os.listdir(run_dir))
    assert {"fakes000000_label.png", "fakes000000_mv.png", "quality.jsonl"} <= files
    g_config, state, _ = _jax_reads(os.path.join(run_dir, "network-final.ckpt"))
    assert g_config["class_name"] == "TriPlaneSemanticEntangleGenerator_withBG"
    assert "backbone_bg" in state["G"] and "backbone_bg" in state["G_ema"]
    assert "D_semantic" in state and "opt_D_semantic" in state


# --- each new generator's tree through checkpoints and the converter ---------------

VARIANTS = {
    "eg3d": dict(render_mask=False),
    "background": dict(render_mask=True, use_bg=True),
    "two_backbones": dict(render_mask=True, class_name="TriPlaneSemanticGenerator"),
    "entangled_mapping": dict(render_mask=True),
}


def _reference_state_dict(G):
    """The port's state_dict under the reference's names (the decoders'
    Sequential indices), which share its layouts."""
    out = {}
    for name, t in G.state_dict().items():
        parts = name.split(".")
        for i in range(1, len(parts)):
            if parts[i - 1] in ("net", "net_semantic") and parts[i] in ("fc0", "fc1"):
                parts[i] = str(int(parts[i][2:]) * 2)
        out[".".join(parts)] = t
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_generator_checkpoints_both_ways(name, tmp_path):
    kw = dict(VARIANTS[name])
    cfg = small_cfg(tconfig, **kw)
    if name == "entangled_mapping":
        cfg["mapping_kwargs"]["class_name"] = "MaskMappingNetwork"
    G = tbuild(device="cpu", seed=3, **cfg)
    tree = bridge.params_to_jax(G)
    jG = jbuild(**cfg)
    template = {"G_ema": jax.eval_shape(jG.init, jax.random.PRNGKey(0))}

    # the port writes, the JAX package reads
    path = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(path, {"G_ema": tree}, config={"g_config": cfg}, step=7)
    state, step = jckpt.load_checkpoint(path, template)
    assert step == 7
    assert_trees_equal(jax.device_get(state["G_ema"]), tree)

    # the JAX package writes (other values), the port's apps build the class
    moved = jax.tree_util.tree_map(lambda a: jnp.asarray(a) * 0.5 + 0.25, state["G_ema"])
    path2 = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path2, {"G_ema": moved}, config={"g_config": cfg}, step=8)
    G2, app = build_app_generator("seg2cat", checkpoint=path2, device="cpu")
    assert type(G2) is type(G) and app["neural_rendering_resolution"] == 64
    assert type(G2.backbone.mapping).__name__ == type(G.backbone.mapping).__name__
    assert_trees_equal(bridge.params_to_jax(G2), jax.device_get(moved))

    # the reference-pickle converter maps the reference's names onto the tree
    converted = tconvert.convert_state_dict(_reference_state_dict(G), tree)
    assert_trees_equal(converted, tree)
