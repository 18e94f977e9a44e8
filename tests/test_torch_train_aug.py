"""The training phases with ADA (`aug_p`) against the JAX package's, and the
loop's ADA heuristic.

Each phase runs at the setting and tolerances of
tests/test_torch_train_phases.py (its helpers), with `train.py`'s augment
set on both losses: JAX's draws, the pipe's included, are recorded under
jit and handed to the port's hooks (`shared_draws`).  JAX gives a phase's
pipe calls one key (`fold_in(rng, 77)`), so the fake and the real batch of
a D phase see the same transforms; the port's calls of one phase draw from
one seed, and here from JAX's recorded draws, one set per call.  Loss
1e-4 relative; per-leaf gradient max |g - g_jax| <= 1e-3 max |g_jax| + 1e-6
(as there: summation orders differ, and R1's double backward through the
pipe's gathers amplifies them).

The loop: two steps of the tiny recipe with `--aug ada` on the CPU, a
tick each step and the heuristic every step: the `aug_p` each step ran
with and each tick's `Progress/augment_p` are `ada_update_p` folded over
the ticks' `Loss/signs/real` (exact: both are the same float arithmetic);
the first tick's image snapshot writes a finite feature-distance trend to
`quality.jsonl`, and every TensorBoard record passes its CRC checks.
"""

import json
import math
import os

import pytest
import torch

from pix2pix3d_tpu.train.augment import AugmentPipe as JPipe

from pix2pix3d_tpu_torch.train import __main__ as tcli
from pix2pix3d_tpu_torch.train.augment import AugmentPipe as TPipe, ada_update_p
from pix2pix3d_tpu_torch.train.loop import training_loop
from pix2pix3d_tpu_torch.train.loss import Pix2Pix3DLoss
from pix2pix3d_tpu_torch.train.trainer import Trainer

from test_torch_train_data import folder  # noqa: F401  (fixture)
from test_torch_train_sinks import read_records
from test_torch_train_phases import (assert_grads_close, assert_loss_close,
                                     BLUR, coin_key, jit_with_draws, _jb,
                                     make_batch, Nets, NRR,
                                     port_value_and_grad, shared_draws,
                                     to_torch, two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]

AUG = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
           brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)
AUG_P = 0.6


@pytest.fixture(scope="module")
def setup():
    nets = Nets()
    nets.loss.augment_pipe = JPipe(**AUG)
    nets.tloss.augment_pipe = TPipe(**AUG)
    L = nets.loss

    def vg(f, p):
        import jax
        return jax.value_and_grad(f, has_aux=True)(p)

    fns = {
        "gmain": jit_with_draws(
            lambda pg, pd, pds, batch, z, c, key: vg(
                lambda p: L.g_main(p, pd, pds, batch, z, c, key, BLUR, NRR,
                                   aug_p=AUG_P), pg)),
        "dmain": jit_with_draws(
            lambda pd, pg, batch, z, c, key: vg(
                lambda p: L.d_main(p, pg, batch, z, c, key, BLUR, NRR,
                                   aug_p=AUG_P), pd)),
        "dreg": jit_with_draws(
            lambda pd, batch, key: vg(
                lambda p: L.d_r1(p, batch, key, BLUR, NRR, aug_p=AUG_P), pd)),
        "dsmain": jit_with_draws(
            lambda pds, pg, batch, z, c, key: vg(
                lambda p: L.d_semantic_main(p, pg, batch, z, c, key, BLUR, NRR,
                                            aug_p=AUG_P), pds)),
        "dsreg": jit_with_draws(
            lambda pds, batch, key: vg(
                lambda p: L.d_semantic_r1(p, batch, key, BLUR, NRR,
                                          aug_p=AUG_P), pds)),
    }
    batch, gen_z, gen_c = make_batch(seed=4)
    return nets, fns, batch, gen_z, gen_c


@pytest.mark.parametrize("phase", ["gmain", "dmain", "dreg", "dsmain", "dsreg"])
def test_phases_with_aug_match_jax(setup, shared_draws, phase):
    nets, fns, batch, gen_z, gen_c = setup
    P = nets.params
    key = coin_key(0.0, start=500)
    tb = to_torch(batch)
    gen = torch.Generator()
    L = nets.tloss
    z = {i: torch.from_numpy(gen_z[i]) for i in range(4)}
    c = {i: torch.from_numpy(gen_c[i]) for i in range(4)}
    if phase == "gmain":
        L.lambda_cross_view = nets.loss.lambda_cross_view = 0.0
        try:
            ((value, stats), grads), draws = fns["gmain"](
                P["G"], P["D"], P["D_semantic"], _jb(batch), gen_z[0], gen_c[0], key)
        finally:
            nets.loss.lambda_cross_view = 1e-4
        fn = lambda: L.g_main(tb, z[0], c[0], gen, BLUR, NRR, aug_p=AUG_P)
        module = nets.tG
    elif phase == "dmain":
        ((value, (stats, _)), grads), draws = fns["dmain"](
            P["D"], P["G"], _jb(batch), gen_z[2], gen_c[2], key)
        fn = lambda: L.d_main(tb, z[2], c[2], gen, BLUR, NRR, aug_p=AUG_P)
        module = nets.tD
    elif phase == "dreg":
        ((value, stats), grads), draws = fns["dreg"](P["D"], _jb(batch), key)
        fn = lambda: L.d_r1(tb, gen, BLUR, NRR, aug_p=AUG_P)
        module = nets.tD
    elif phase == "dsmain":
        ((value, stats), grads), draws = fns["dsmain"](
            P["D_semantic"], P["G"], _jb(batch), gen_z[3], gen_c[3], key)
        fn = lambda: L.d_semantic_main(tb, z[3], c[3], gen, BLUR, NRR, aug_p=AUG_P)
        module = nets.tDs
    else:
        ((value, stats), grads), draws = fns["dsreg"](P["D_semantic"], _jb(batch), key)
        fn = lambda: L.d_semantic_r1(tb, gen, BLUR, NRR, aug_p=AUG_P)
        module = nets.tDs
    assert sum(k == "randint" for k, _ in draws) >= 1, "JAX's pipe did not run"
    shared_draws.extend(draws)
    try:
        got, _, tgrads = port_value_and_grad(fn, module, list(nets.modules().values()))
    finally:
        L.lambda_cross_view = 1e-4
    assert_loss_close(got, value)
    assert_grads_close(tgrads, grads, phase)


def test_phase_aug_is_one_seed_per_phase():
    """Without a pipe or `aug_p` a phase draws nothing for augmentation;
    with both, the phase's pipe calls all draw the same numbers."""
    loss = Pix2Pix3DLoss(None, None)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert loss.phase_aug(gen, 0.5) is None
    loss.augment_pipe = TPipe(**AUG)
    assert loss.phase_aug(gen, None) is None
    assert torch.equal(gen.get_state(), state)
    make, p = loss.phase_aug(gen, 0.5)
    assert p == 0.5 and not torch.equal(gen.get_state(), state)
    x = torch.rand(2, 16, 16, 6)
    assert torch.equal(loss.augment_pipe(x, 1.0, make()),
                       loss.augment_pipe(x, 1.0, make()))


def test_loop_runs_the_ada_heuristic(folder, tmp_path):  # noqa: F811
    argv = ["--outdir", str(tmp_path), "--cfg", "afhq", "--data", folder["imgs"],
            "--mask_data", folder["masks"], "--batch", "2", "--gamma", "5",
            "--semantic_channels", "6", "--render_mask", "True",
            "--neural_rendering_resolution_initial", "16", "--cbase", "512",
            "--cmax", "16", "--mbstd-group", "2", "--aug", "ada", "--target", "0.0",
            "--kimg", "0.004", "--tick", "0.002", "--device", "cpu"]
    conf = tcli.run_config(tcli.parser().parse_args(argv))
    conf["g_config"]["rendering_kwargs"].update(depth_resolution=4,
                                                depth_resolution_importance=4)
    assert conf["augment_kwargs"] == AUG and conf["ada_target"] == 0.0
    conf.update(ada_interval=1, ada_kimg=0.01, snapshot_ticks=None,
                image_snapshot_ticks=10, g_reg_interval=None)
    used = []

    def step_fn(trainer, *args, **kw):
        used.append(kw["aug_p"])
        return Trainer.step(trainer, *args, **kw)

    run_dir = str(tmp_path / "run")
    training_loop(run_dir=run_dir, step_fn=step_fn, **conf)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert len(ticks) == 2 == len(used)
    p = 0.0
    for i, tick in enumerate(ticks):
        assert used[i] == p
        p = ada_update_p(p, tick["Loss/signs/real"], 2, ada_interval=1,
                         ada_kimg=0.01, ada_target=0.0)
        assert tick["Progress/augment_p"] == p
    assert any(t["Loss/signs/real"] != 0 for t in ticks)
    # the sinks: tick 0's image snapshot gave the trend; the TensorBoard file
    # holds the header, two ticks' scalars, the trend and four grids
    with open(os.path.join(run_dir, "quality.jsonl")) as f:
        quality = [json.loads(line) for line in f]
    assert len(quality) == 1 and math.isfinite(quality[0]["fd_proxy_real_fake"])
    (events,) = [n for n in os.listdir(run_dir) if n.startswith("events.out.tfevents.")]
    assert len(read_records(os.path.join(run_dir, events))) == 1 + 2 + 1 + 4
