"""The full training checkpoint between the packages, and the port's
training CLI end to end.

- A training state written by the JAX package's `save_checkpoint` (G, D,
  D_semantic, G_ema and each network's optax Adam state, after two Adam
  updates, and the step) is read by the port's `load_checkpoint` against
  `Trainer.state_tree()` as its template, loaded into the port's networks
  and optimizers, and given back by `state_tree()` bit for bit; the port's
  `save_checkpoint` of it is read by the JAX package's
  `load_checkpoint(path, state_template)` bit for bit.  One more Adam step
  on the same gradient then moves both packages' parameters alike (1e-6
  absolute and relative, an ulp of the mapping's weights near 1e2: torch's
  Adam divides sqrt(nu) and the bias correction's root separately, optax
  their quotient's root).
- `python -m pix2pix3d_tpu_torch.train` (its `main`) runs the seg2cat
  recipe's flags on the CPU at a small width for one step on a synthetic
  folder, its step with TF32 off (the loop's own policy, restored after
  the run), and writes `stats.jsonl`, the image grids (the port's own PNG
  encoder) and a checkpoint that the JAX package's
  `load_checkpoint(path, state_template)` reads against its own trainer's
  state, leaf for leaf equal to the port's trainer.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import PIL.Image
import pytest
import torch

from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.nn.discriminator import DualDiscriminator as JDual
from pix2pix3d_tpu.parallel.trainer import Trainer as JTrainer, _lazy_adam, make_mesh
from pix2pix3d_tpu.train.checkpoint import (load_checkpoint as jload,
                                            save_checkpoint as jsave)
from pix2pix3d_tpu.train.loss import Pix2Pix3DLoss as JLoss

from pix2pix3d_tpu_torch.train import __main__ as tcli
from pix2pix3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pix2pix3d_tpu_torch.parallel.trainer import Trainer

from test_torch_train_phases import Nets, two_torch_threads
from test_torch_train_data import folder  # noqa: F401  (fixture)

__all__ = ["two_torch_threads"]

OPTS = {"G": (0.0025, 4), "D": (0.002, 16), "D_semantic": (0.002, 16)}
# leaves the JAX trainer's gradients are always 0 for (w_avg is read only
# under truncation, noise_const only with noise_mode 'const'), so their Adam
# moments stay 0; the port writes zeros for them
BUFFERS = ("w_avg", "noise_const")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _as_dict(state):
    from flax import serialization
    return serialization.to_state_dict(jax.device_get(state))


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb), set(la) ^ set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert np.array_equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def jax_state():
    """The JAX trainer's state tree over the tiny networks, after two Adam
    updates of every network on random gradients (0 for the buffers)."""
    nets = Nets()
    rng = np.random.RandomState(0)
    state = {}
    for net, (lr, interval) in OPTS.items():
        params = jax.tree_util.tree_map(jnp.asarray, nets.params[net])
        opt = _lazy_adam(lr, (0.0, 0.99), 1e-8, interval)
        st = opt.init(params)
        for _ in range(2):
            g = jax.tree_util.tree_map_with_path(
                lambda path, p: jnp.asarray(np.asarray(rng.randn(*p.shape), np.float32)
                                            * (path[-1].key not in BUFFERS)), params)
            upd, st = opt.update(g, st, params)
            params = optax.apply_updates(params, upd)
        state[net] = params
        state[f"opt_{net}"] = st
    state["G_ema"] = jax.tree_util.tree_map(lambda p: p * 0.5, state["G"])
    return nets, jax.device_get(state)


def test_training_checkpoint_both_ways(jax_state, tmp_path):
    nets, state = jax_state
    path = str(tmp_path / "jax.ckpt")
    jsave(path, state, config={"g_config": {}}, step=1234)

    trainer = Trainer(nets.tloss)
    template = trainer.state_tree()
    tree, step = load_checkpoint(path, template)
    assert step == 1234
    trainer.load_state_tree(tree)
    back = trainer.state_tree()
    assert_trees_equal(back, _as_dict(state))

    path2 = str(tmp_path / "port.ckpt")
    save_checkpoint(path2, back, step=step)
    restored, step2 = jload(path2, state)
    assert step2 == 1234
    assert_trees_equal(_as_dict(restored), _as_dict(state))

    # one more Adam step on the same gradient, in both packages
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(jnp.asarray, state["G"])
    g = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(np.asarray(rng.randn(*p.shape), np.float32)
                                    * (path[-1].key not in BUFFERS)), params)
    upd, _ = _lazy_adam(0.0025, (0.0, 0.99), 1e-8, 4).update(g, state["opt_G"], params)
    want = jax.device_get(optax.apply_updates(params, upd))
    from pix2pix3d_tpu_torch import bridge
    tg = bridge.params_from_jax(jax.device_get(g))
    for name, p in nets.tG.named_parameters():
        p.grad = tg[name]
    trainer.opt_g.step()
    got = trainer.state_tree()["G"]
    for (k, a), (_, b) in zip(_leaves(got), _leaves(_as_dict(want))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=str(k))


def test_load_checkpoint_refuses_a_mismatched_template(jax_state, tmp_path):
    nets, state = jax_state
    path = str(tmp_path / "jax.ckpt")
    jsave(path, {k: v for k, v in state.items() if k != "opt_D"}, step=1)
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(path, Trainer(nets.tloss).state_tree())


def test_cli_runs_the_recipe_end_to_end(folder, tmp_path):  # noqa: F811
    outdir = tmp_path / "runs"
    argv = ["--outdir", str(outdir), "--cfg", "afhq", "--data", folder["imgs"],
            "--mask_data", folder["masks"], "--data_type", "seg", "--batch", "2",
            "--gamma", "5", "--semantic_channels", "6", "--render_mask", "True",
            "--dis_mask", "True", "--neural_rendering_resolution_initial", "16",
            "--gen_pose_cond", "True", "--random_c_prob", "0.5",
            "--lambda_d_semantic", "0.1", "--lambda_lpips", "1",
            "--lambda_cross_view", "1e-4", "--only_raw_recons", "True",
            "--cbase", "512", "--cmax", "16", "--mbstd-group", "2",
            "--kimg", "0.002", "--tick", "0.002", "--snap", "1", "--device", "cpu"]
    policies = []

    def step_fn(trainer, *args, **kwargs):
        # the loop's steps run with TF32 off (the JAX trainer's HIGHEST)
        policies.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
        return Trainer.step(trainer, *args, **kwargs)

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    run_dir = tcli.main(argv, step_fn=step_fn)
    assert policies == [(False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    files = set(os.listdir(run_dir))
    for name in ("stats.jsonl", "reals.png", "mask.png", "fakes000000.png",
                 "fakes000000_raw.png", "fakes000000_depth.png",
                 "fakes000000_label.png", "fakes000000_mv.png",
                 "network-snapshot-000000.ckpt", "network-final.ckpt",
                 "training_options.json"):
        assert name in files, name
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        fields = json.loads(f.readline())
    for k in ("Loss/G/loss", "Loss/D/loss", "Loss/D/reg", "Loss/D/reg_semantic",
              "Loss/G/loss_cross_view"):
        assert np.isfinite(fields[k]), k
    assert np.array(PIL.Image.open(os.path.join(run_dir, "fakes000000.png"))).shape \
        == (128, 256, 3)   # two 128^2 fakes side by side

    # the JAX package reads the final checkpoint against its own trainer
    path = os.path.join(run_dir, "network-final.ckpt")
    with open(path + ".json") as f:
        g_config = json.load(f)["g_config"]
    d_kw = dict(c_dim=25, img_resolution=128, channel_base=512, channel_max=16,
                num_fp16_res=4, conv_clamp=256, epilogue_kwargs={"mbstd_group_size": 2})
    G = jbuild(**g_config)
    loss = JLoss(G, JDual(img_channels=3, **d_kw), D_semantic=JDual(img_channels=9, **d_kw))
    trainer = JTrainer(loss, mesh=make_mesh(jax.devices()[:1]))
    template = jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))
    state, step = jload(path, template)
    assert step == 2
    port, _ = load_checkpoint(path)
    assert_trees_equal(_as_dict(state), port)
    assert int(state["opt_G"][0].count) == 2 and int(state["opt_D"][0].count) == 2
