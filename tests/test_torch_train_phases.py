"""The port's generator phases against the JAX package's, value and gradient,
and the helpers the other tests/test_torch_train_*.py files share.

`g_main` (the pose coin at 0 and at 1) and `cross_view_prep` here;
`d_main`, `d_r1`, `d_semantic_main`, `d_semantic_r1` in
tests/test_torch_train_dphases.py; `g_reg` in tests/test_torch_train_greg.py.
Each phase runs at the `_tiny_loss` size
of tests/test_loss_gating.py (afhq, 128^2, cbase 512, cmax 16, 4+4 depth
samples, nrr 16, batch 2) with the seg2cat recipe's loss settings
(D_semantic on, LPIPS on the random VGG, cross-view on, only_raw_recons,
random_c_prob 0.5, the blur fade at sigma 10), f32, weights bridged from
the port's init through `bridge.params_to_jax` into the JAX phases and
back with `bridge.params_from_jax` (`Nets`).

The two frameworks draw different numbers, so each JAX phase runs jitted
with `jax.random.normal`/`uniform` recorded (`record_draws`), and the port
consumes those draws, in order, through its draw hooks (`shared_draws`):
`nn.synthesis.draw_noise`, `render.renderer._uniform`,
`train.loss.draw_uniform`/`draw_normal`, `nn.discriminator.draw_normal` and
`train.augment.draw_uniform`/`draw_normal`/`draw_randint`.
Each JAX phase is jitted once per module (`jax_phases`), with every array
an argument, and shared by the cases.

Tolerances (the reasons):
- loss values: 1e-4 relative (as tests/test_torch_nn.py: f32 on both
  sides, summation order differs);
- gradients, per leaf: max |g - g_jax| <= 1e-3 * max |g_jax| + 1e-6 (the
  backward sums over batch, pixels and samples in other orders, and the
  importance renderer's sort and the R1 double backward amplify the
  rounding of their inputs).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.nn.discriminator import DualDiscriminator as JDual
from pix2pix3d_tpu.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                         pose_to_conditioning)
from pix2pix3d_tpu.train.loss import Pix2Pix3DLoss as JLoss
from pix2pix3d_tpu.train.lpips import LPIPS as JLPIPS

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.models.triplane import init_parameters
from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.nn import synthesis as tsyn
from pix2pix3d_tpu_torch.render import renderer as trenderer
from pix2pix3d_tpu_torch.train import augment as taug
from pix2pix3d_tpu_torch.train import loss as tloss
from pix2pix3d_tpu_torch.train.lpips import LPIPS as TLPIPS
from pix2pix3d_tpu_torch.train.trainer import _set_trainable

RES, NRR, B = 128, 16, 2
BLUR = (10.0, 32)           # sigma 10 (the recipe's blur_init), half width 32
LOSS_KW = dict(r1_gamma=5.0, random_c_prob=0.5, lambda_l1=1.0, lambda_lpips=1.0,
               blur_init_sigma=10, blur_fade_kimg=25,
               lambda_D_semantic=0.1, only_raw_recons=True,
               lambda_cross_view=1e-4, neural_rendering_resolution_initial=NRR)
D_KW = dict(c_dim=25, img_resolution=RES, channel_base=512, channel_max=16,
            num_fp16_res=0, epilogue_kwargs={"mbstd_group_size": 2})
LOSS_RTOL = 1e-4


def tiny_cfg(cfg_mod, reg_type="l1"):
    """tests/test_loss_gating.py::_tiny_loss's generator config."""
    cfg = cfg_mod.generator_config(cfg="afhq", resolution=RES, data_type="seg",
                                   semantic_channels=6, cbase=512, cmax=16,
                                   sr_num_fp16_res=0, render_mask=True,
                                   gen_pose_cond=True, reg_type=reg_type)
    cfg["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4)
    cfg["mapping_kwargs"]["in_resolution"] = RES
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    return cfg


def jax_lpips_from(tl):
    """The JAX package's LPIPS holding the port module `tl`'s weights (its
    own random init is tests/test_torch_train_nn.py's)."""
    jl = JLPIPS.__new__(JLPIPS)
    jl.has_pretrained = False
    jl.params = {k: (v.numpy().transpose(2, 3, 1, 0) if v.ndim == 4 else v.numpy())
                 for k, v in tl.state_dict().items()}
    return jl


class Nets:
    """The JAX networks and loss and the port's, on the same weights: the
    port draws them (`torch.Generator().manual_seed(0)`, the JAX `init`
    scheme), `bridge.params_to_jax` gives the JAX trees, and
    `bridge.params_from_jax` loads those back into the port's modules."""

    def __init__(self, reg_type="l1", loss_kw=None):
        kw = dict(LOSS_KW, **(loss_kw or {}))
        self.tG = tbuild(device="cpu", train=True, **tiny_cfg(tconfig, reg_type))
        self.tD = tdisc.DualDiscriminator(img_channels=3, **D_KW)
        self.tDs = tdisc.DualDiscriminator(img_channels=9, **D_KW)
        gen = torch.Generator().manual_seed(1)
        init_parameters(self.tD, gen)
        init_parameters(self.tDs, gen)
        self.tlpips = TLPIPS()
        self.tloss = tloss.Pix2Pix3DLoss(self.tG, self.tD, D_semantic=self.tDs,
                                         lpips=self.tlpips, **kw)
        self.params = {k: bridge.params_to_jax(m) for k, m in self.modules().items()}
        self.load_port(self.params)
        self.G = jbuild(**tiny_cfg(jconfig, reg_type))
        self.D = JDual(img_channels=3, **D_KW)
        self.Ds = JDual(img_channels=9, **D_KW)
        self.lpips = jax_lpips_from(self.tlpips)
        self.loss = JLoss(self.G, self.D, D_semantic=self.Ds, lpips=self.lpips, **kw)

    def modules(self):
        return {"G": self.tG, "D": self.tD, "D_semantic": self.tDs}

    def load_port(self, params):
        for k, m in self.modules().items():
            m.load_state_dict(bridge.params_from_jax(params[k]), strict=True)


def make_batch(seed=0, yaw=0.5, b=B):
    """A batch of `b` random images and 6-class masks under the afhq pose,
    and per-phase latents and random poses `[4, b, ...]`, as numpy."""
    B = b
    rng = np.random.RandomState(seed)
    c2w = LookAtPoseSampler.sample(None, np.pi / 2, np.pi / 2, [0, 0, -0.06],
                                   radius=2.7, batch_size=B)
    intr = fov_to_intrinsics(18.837)
    pose = np.asarray(pose_to_conditioning(c2w, intr))
    batch = {"image": rng.rand(B, RES, RES, 3).astype(np.float32) * 2 - 1,
             "mask": rng.randint(0, 6, (B, RES, RES, 1)).astype(np.float32),
             "pose": pose}
    gen_c = []
    for i in range(4):
        c2w_r = LookAtPoseSampler.sample(None, np.pi / 2 + yaw + 0.1 * i,
                                         np.pi / 2 - 0.3, [0, 0, -0.06],
                                         radius=2.7, batch_size=B)
        gen_c.append(np.asarray(pose_to_conditioning(c2w_r, intr)))
    gen_z = rng.randn(4, B, 512).astype(np.float32)
    return batch, gen_z, np.stack(gen_c)


def to_torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the port while a module runs: the tests
    share the CPU with other xdist workers, and PyTorch's default (every
    core) stalls them all when several workers run it at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- JAX's draws, recorded and handed to the port ---------------------------

_ORIG = {"normal": jax.random.normal, "uniform": jax.random.uniform,
         "randint": jax.random.randint}


@contextlib.contextmanager
def record_draws(out):
    """Record every `jax.random.normal`/`uniform`/`randint` result into
    `out` as (kind, array) while the block runs (under a jit trace: tracers,
    which the traced function returns)."""
    def wrap(kind):
        def draw(*args, **kwargs):
            value = _ORIG[kind](*args, **kwargs)
            out.append((kind, value))
            return value
        return draw
    for kind in _ORIG:
        setattr(jax.random, kind, wrap(kind))
    try:
        yield out
    finally:
        for kind, fn in _ORIG.items():
            setattr(jax.random, kind, fn)


def jit_with_draws(fn):
    """jit(fn) returning (fn's output, [(kind, draw), ...]) in the order the
    JAX code drew them."""
    kinds = []

    def traced(*args):
        rec = []
        with record_draws(rec):
            out = fn(*args)
        kinds[:] = [k for k, _ in rec]
        return out, [v for _, v in rec]

    jitted = jax.jit(traced)

    def call(*args):
        out, values = jitted(*args)
        return out, list(zip(kinds, (np.asarray(v) for v in values)))
    return call


@pytest.fixture
def shared_draws(monkeypatch):
    """A queue of JAX draws [(kind, array)] that the port's draw hooks hand
    out in order; each hook checks the kind and shape it asks for."""
    queue = []

    def take(kind, shape):
        assert queue, f"the port drew more than the JAX package ({kind} {shape})"
        got_kind, arr = queue.pop(0)
        assert got_kind == kind and tuple(arr.shape) == tuple(shape), \
            (kind, tuple(shape), got_kind, arr.shape)
        return torch.from_numpy(np.array(arr, np.float32))

    def noise(shape, generator, device):
        n, _, h, w = shape
        return take("normal", (n, h, w, 1)).permute(0, 3, 1, 2).contiguous().to(device)

    monkeypatch.setattr(tsyn, "draw_noise", noise)
    monkeypatch.setattr(trenderer, "_uniform",
                        lambda g, shape, device: take("uniform", shape).to(device))
    monkeypatch.setattr(tloss, "draw_uniform",
                        lambda g, shape, device: take("uniform", shape).to(device))
    monkeypatch.setattr(tloss, "draw_normal",
                        lambda g, shape, device: take("normal", shape).to(device))
    monkeypatch.setattr(tdisc, "draw_normal",
                        lambda g, shape, device: take("normal", shape).to(device))
    monkeypatch.setattr(taug, "draw_uniform",
                        lambda g, shape, device: take("uniform", shape).to(device))
    monkeypatch.setattr(taug, "draw_normal",
                        lambda g, shape, device: take("normal", shape).to(device))
    monkeypatch.setattr(taug, "draw_randint",
                        lambda g, lo, hi, shape, device: take("randint", shape).to(device))
    yield queue
    assert not queue, f"the port drew {len(queue)} fewer numbers than JAX"


def port_value_and_grad(fn, module, modules):
    """(loss, aux, {name: grad}) of `fn()` w.r.t. `module`'s parameters, the
    other networks frozen; unreached parameters get zeros."""
    _set_trainable(module, modules)
    value, aux = fn()
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
    _set_trainable(None, modules)
    return value.detach(), aux, {k: (torch.zeros_like(p) if g is None else g)
                                 for (k, p), g in zip(params.items(), grads)}


def assert_grads_close(got, jax_grads, what=""):
    """Per leaf: max |g - g_jax| <= 1e-3 * max |g_jax| + 1e-6."""
    want = bridge.params_from_jax(jax.device_get(jax_grads))
    assert set(got) <= set(want), set(got) - set(want)
    bad = []
    for k, g in got.items():
        w = want[k].numpy()
        err = np.abs(g.detach().numpy() - w).max()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        if not err <= tol:
            bad.append((k, float(err), float(tol)))
    assert not bad, (what, bad[:10], len(bad))


def assert_loss_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# --- the JAX phases, jitted once per module ---------------------------------

def jax_phase_fns(nets):
    """{phase: jitted fn(params..., inputs..., key) -> ((loss, aux), grads),
    draws)} over the JAX networks of `nets`."""
    L = nets.loss

    def vg(f, p):
        return jax.value_and_grad(f, has_aux=True)(p)

    return {
        "cv_prep": jit_with_draws(
            lambda pg, batch, z, c, key: L.cross_view_prep(pg, z, batch, c, key, NRR)),
        "gmain": jit_with_draws(
            lambda pg, pd, pds, batch, z, c, key, cv: vg(
                lambda p: L.g_main(p, pd, pds, batch, z, c, key, BLUR, NRR,
                                   cv_aux=cv), pg)),
        "greg": jit_with_draws(
            lambda pg, batch, z, key: vg(lambda p: L.g_reg(p, batch, z, key), pg)),
        "dmain": jit_with_draws(
            lambda pd, pg, batch, z, c, key: vg(
                lambda p: L.d_main(p, pg, batch, z, c, key, BLUR, NRR), pd)),
        "dreg": jit_with_draws(
            lambda pd, batch, key: vg(lambda p: L.d_r1(p, batch, key, BLUR, NRR), pd)),
        "dsmain": jit_with_draws(
            lambda pds, pg, batch, z, c, key: vg(
                lambda p: L.d_semantic_main(p, pg, batch, z, c, key, BLUR, NRR), pds)),
        "dsreg": jit_with_draws(
            lambda pds, batch, key: vg(
                lambda p: L.d_semantic_r1(p, batch, key, BLUR, NRR), pds)),
    }


def coin_key(value, start=100):
    """A key whose g_main/d_main pose coin (split(key, 6)[0], p 0.5) is
    `value`."""
    for s in range(start, start + 100):
        key = jax.random.PRNGKey(s)
        r_coin = jax.random.split(key, 6)[0]
        if float(jax.random.uniform(r_coin) < 0.5) == value:
            return key
    raise AssertionError("no key gives that coin")


@pytest.fixture(scope="module")
def setup():
    nets = Nets()
    batch, gen_z, gen_c = make_batch()
    return nets, jax_phase_fns(nets), batch, gen_z, gen_c


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("coin", [0.0, 1.0])
def test_g_main_and_cross_view_prep(setup, shared_draws, coin):
    nets, fns, batch, gen_z, gen_c = setup
    P = nets.params
    key = coin_key(coin)
    cv, draws_cv = fns["cv_prep"](P["G"], _jb(batch), gen_z[0], gen_c[0], key)
    ((value, stats), grads), draws = fns["gmain"](
        P["G"], P["D"], P["D_semantic"], _jb(batch), gen_z[0], gen_c[0], key, cv)
    assert draws[0][0] == "uniform" and draws[0][1].shape == ()
    assert float(draws[0][1] < 0.5) == coin

    tb, z, c = to_torch(batch), torch.from_numpy(gen_z[0]), torch.from_numpy(gen_c[0])
    shared_draws.extend(draws_cv)
    tcv = nets.tloss.cross_view_prep(z, tb, c, torch.Generator(), NRR)
    for k in ("proj_mask", "recon_sem_raw"):
        np.testing.assert_allclose(tcv[k].numpy(), np.asarray(cv[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert np.array_equal(tcv["proj_mask"].numpy(), np.asarray(cv["proj_mask"]))
    # the port's g_main on the port's own cross-view renders
    shared_draws.extend(draws)
    got, tstats, tgrads = port_value_and_grad(
        lambda: nets.tloss.g_main(tb, z, c, torch.Generator(), BLUR, NRR, cv_aux=tcv),
        nets.tG, list(nets.modules().values()))
    assert_loss_close(got, value)
    for k in ("Loss/G/loss_img_reconstruction", "Loss/G/loss_cross_view",
              "Loss/G/loss_semantic_reconstruction", "Loss/scores/fake_semantic"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(stats[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    assert_grads_close(tgrads, grads, "g_main")
