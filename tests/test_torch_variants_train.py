"""The training phases of the generators that train.py's flags select
besides the shipped one, the port's against the JAX package's, value and
gradient: train.py's defaults (`--render_mask False --dis_mask False`:
`TriPlaneGenerator`, no D_semantic), its G main and D main phases; and
`--render_mask True --dis_mask True --use_bg True --silhouette_loss True`
(the background generator), its G main phase with the silhouette term.

The setting of tests/test_torch_train_phases.py (its helpers and its loss
settings: the seg2cat recipe's weights, random_c_prob 0.5 with the pose
coin at 0, so the reconstruction terms are on; gamma 5, blur sigma 10):
afhq, 128², cbase 512, cmax 16, nrr 16, batch 2, here with 8 + 8 depth
samples, without the cross-view term (it needs semantic outputs) and
without LPIPS (that file holds the port's LPIPS to JAX's in these phases;
here it would add ~8 s of compilation a phase).  The CLI test runs
train.py's own loss defaults.  f32; the port draws the weights and
`bridge.params_to_jax` gives JAX the same ones.  JAX's draws (the pose
coin, the backbones' noise, the renderer's jitter, disc_c_noise) are
recorded under jit and handed to the port's draw hooks in order.

Why not train.py's loss defaults here (lambda_l1 0, lambda_lpips 10 on the
random VGG): without the L1 and semantic reconstruction terms the G
gradient is the random-VGG LPIPS and GAN terms', and some of its leaves
(noise strengths, the 256² block's affine) move in JAX itself by up to
1.9e-3 of their largest entry when z moves by one part in 1e7, beyond the
per-leaf gate; the port meets JAX's loss value there to 1e-6.

Tolerances (that file's, with its reasons): loss values 1e-4 relative;
gradients, per leaf, max |g - g_jax| <= 1e-3 * max |g_jax| + 1e-6.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.nn.discriminator import DualDiscriminator as JDual
from pix2pix3d_tpu.train.loss import Pix2Pix3DLoss as JLoss

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.models.triplane import init_parameters
from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.train import loss as tloss

from test_torch_train_phases import LOSS_KW as PHASES_LOSS_KW
from test_torch_train_phases import (assert_grads_close, assert_loss_close, BLUR,
                                     coin_key, D_KW, _jb, jit_with_draws,
                                     make_batch, NRR, port_value_and_grad,
                                     RES, shared_draws, to_torch,
                                     two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]

# the recipe's loss settings of tests/test_torch_train_phases.py, without
# the cross-view term (and the phases run without LPIPS)
LOSS_KW = {k: v for k, v in PHASES_LOSS_KW.items() if k != "lambda_cross_view"}


def variant_cfg(cfg_mod, **kw):
    cfg = cfg_mod.generator_config(cfg="afhq", resolution=RES, data_type="seg",
                                   semantic_channels=6, cbase=512, cmax=16,
                                   sr_num_fp16_res=0, gen_pose_cond=True, **kw)
    cfg["rendering_kwargs"].update(depth_resolution=8, depth_resolution_importance=8)
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    return cfg


class VariantNets:
    """The port's G, D (and D_semantic) drawn from seeds, the JAX loss on
    the same weights (`bridge.params_to_jax`)."""

    def __init__(self, d_semantic, loss_kw, **cfg_kw):
        self.tG = tbuild(device="cpu", train=True, **variant_cfg(tconfig, **cfg_kw))
        self.tD = tdisc.DualDiscriminator(img_channels=3, **D_KW)
        self.tDs = (tdisc.DualDiscriminator(img_channels=9, **D_KW)
                    if d_semantic else None)
        gen = torch.Generator().manual_seed(1)
        for m in (self.tD, self.tDs):
            if m is not None:
                init_parameters(m, gen)
        kw = dict(LOSS_KW, **loss_kw)
        self.tloss = tloss.Pix2Pix3DLoss(self.tG, self.tD, D_semantic=self.tDs,
                                         lpips=None, **kw)
        self.params = {k: bridge.params_to_jax(m) for k, m in self.modules().items()}
        G = jbuild(**variant_cfg(jconfig, **cfg_kw))
        Ds = JDual(img_channels=9, **D_KW) if d_semantic else None
        self.loss = JLoss(G, JDual(img_channels=3, **D_KW), D_semantic=Ds,
                          lpips=None, **kw)

    def modules(self):
        mods = {"G": self.tG, "D": self.tD}
        if self.tDs is not None:
            mods["D_semantic"] = self.tDs
        return mods


def _vg(f, p):
    return jax.value_and_grad(f, has_aux=True)(p)


@pytest.fixture(scope="module")
def eg3d():
    """train.py's defaults: TriPlaneGenerator, D only."""
    nets = VariantNets(False, {}, render_mask=False)
    L = nets.loss
    fns = {
        "gmain": jit_with_draws(lambda pg, pd, batch, z, c, key: _vg(
            lambda p: L.g_main(p, pd, None, batch, z, c, key, BLUR, NRR), pg)),
        "dmain": jit_with_draws(lambda pd, pg, batch, z, c, key: _vg(
            lambda p: L.d_main(p, pg, batch, z, c, key, BLUR, NRR), pd)),
    }
    return nets, fns, make_batch()


def test_triplane_generator_g_main_matches_jax(eg3d, shared_draws):
    """No semantic outputs, so no semantic reconstruction, D_semantic or
    silhouette term: the GAN term and the image reconstruction (L1 and
    LPIPS, here off)."""
    nets, fns, (batch, gen_z, gen_c) = eg3d
    P = nets.params
    ((value, stats), grads), draws = fns["gmain"](
        P["G"], P["D"], _jb(batch), gen_z[0], gen_c[0], coin_key(0.0))
    assert "Loss/G/loss_semantic_reconstruction" not in stats
    shared_draws.extend(draws)
    tb, z, c = to_torch(batch), torch.from_numpy(gen_z[0]), torch.from_numpy(gen_c[0])
    got, tstats, tgrads = port_value_and_grad(
        lambda: nets.tloss.g_main(tb, z, c, torch.Generator(), BLUR, NRR),
        nets.tG, list(nets.modules().values()))
    assert set(tstats) == set(stats)
    assert_loss_close(got, value)
    np.testing.assert_allclose(tstats["Loss/G/loss_img_reconstruction"].numpy(),
                               np.asarray(stats["Loss/G/loss_img_reconstruction"]),
                               rtol=1e-4)
    assert_grads_close(tgrads, grads, "g_main")


def test_triplane_generator_d_main_matches_jax(eg3d, shared_draws):
    """The fakes rendered without gradient, and the ws of the w_avg update."""
    nets, fns, (batch, gen_z, gen_c) = eg3d
    P = nets.params
    ((value, (stats, aux)), grads), draws = fns["dmain"](
        P["D"], P["G"], _jb(batch), gen_z[2], gen_c[2], coin_key(1.0, start=300))
    shared_draws.extend(draws)
    tb = to_torch(batch)
    got, (tstats, taux), tgrads = port_value_and_grad(
        lambda: nets.tloss.d_main(tb, torch.from_numpy(gen_z[2]),
                                  torch.from_numpy(gen_c[2]), torch.Generator(),
                                  BLUR, NRR),
        nets.tD, list(nets.modules().values()))
    assert_loss_close(got, value)
    np.testing.assert_allclose(taux["ws"].numpy(), np.asarray(aux["ws"]),
                               rtol=1e-4, atol=1e-5)
    assert_grads_close(tgrads, grads, "d_main")


@pytest.fixture(scope="module")
def with_bg():
    """`--render_mask True --dis_mask True --use_bg True --silhouette_loss
    True`."""
    nets = VariantNets(True, dict(silhouette_loss=True), render_mask=True,
                       use_bg=True)
    L = nets.loss
    fns = {"gmain": jit_with_draws(lambda pg, pd, pds, batch, z, c, key: _vg(
        lambda p: L.g_main(p, pd, pds, batch, z, c, key, BLUR, NRR), pg))}
    return nets, fns, make_batch(seed=1)


def test_background_generator_g_main_with_silhouette_matches_jax(with_bg, shared_draws):
    """The background backbone's noise drawn after the render's jitter, the
    silhouette MSE on the `weight` image against the mask's foreground, and
    every gradient of G (backbone_bg's included)."""
    nets, fns, (batch, gen_z, gen_c) = with_bg
    P = nets.params
    ((value, stats), grads), draws = fns["gmain"](
        P["G"], P["D"], P["D_semantic"], _jb(batch), gen_z[0], gen_c[0],
        coin_key(0.0, start=200))
    shared_draws.extend(draws)
    tb, z, c = to_torch(batch), torch.from_numpy(gen_z[0]), torch.from_numpy(gen_c[0])
    got, tstats, tgrads = port_value_and_grad(
        lambda: nets.tloss.g_main(tb, z, c, torch.Generator(), BLUR, NRR),
        nets.tG, list(nets.modules().values()))
    assert_loss_close(got, value)
    for k in ("Loss/G/loss_silhouette", "Loss/G/loss_semantic_reconstruction",
              "Loss/scores/fake_semantic"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(stats[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    assert float(tstats["Loss/G/loss_silhouette"][1]) > 0
    assert any(k.startswith("backbone_bg.") and float(g.abs().max()) > 0
               for k, g in tgrads.items())
    assert_grads_close(tgrads, grads, "g_main")
