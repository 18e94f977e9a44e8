"""Training through the frustum-slab renderer (`--sampler frustum`) against
the JAX package, and its per-chunk rematerialization (`frustum_remat`).

The generator of tests/test_torch_train_phases.py (its helpers and
tolerances: loss 1e-4 relative; per-leaf gradient max |g - g_jax| <= 1e-3
max |g_jax| + 1e-6) with `train.py`'s frustum keys at a small size: 8
depth slabs in chunks of 4, f32 slabs (`frustum_bf16 False`), so that both
packages compute in f32 and only summation orders differ.  The frustum
renderer draws nothing; the phase's other draws are JAX's, handed to the
port's hooks.

- `g_main` (the random pose, no cross-view term) against JAX's, whose
  renderer rematerializes every chunk too.  Batch 1 and one render: the
  256^2 planes' shear passes dominate the CPU's time.
- The renderer alone on 64^2 planes (tests/test_torch_render.py's
  helpers): its gradients w.r.t. the planes and the decoder against
  JAX's (the loss of tests/test_frustum.py's differentiability test);
  `frustum_remat` on and off give the same loss and gradients (bit for
  bit: the recompute repeats the forward exactly on the CPU), and with it
  on the forward keeps less for the backward, by at least every sample's
  features and colors (the bytes the autograd graph saves, counted with
  `saved_tensors_hooks`); without
  gradients (serving) the setting changes nothing.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.render import frustum as jfr

from pix2pix3d_tpu_torch.render import frustum as tfr

from test_torch_train_phases import (assert_grads_close, assert_loss_close,
                                     BLUR, coin_key, jit_with_draws, _jb,
                                     make_batch, Nets, NRR,
                                     port_value_and_grad, shared_draws,
                                     to_torch, two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]

FRUSTUM = dict(sampler="frustum", frustum_depth_steps=8, frustum_chunk=4,
               frustum_bf16=False)
RENDER_OPTS = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
               "white_back": False, "depth_resolution": 16,
               "depth_resolution_importance": 16}


@pytest.fixture(scope="module")
def setup():
    nets = Nets(loss_kw={"lambda_cross_view": 0.0})
    nets.G.rendering_kwargs.update(FRUSTUM)
    nets.tG.rendering_kwargs.update(FRUSTUM)
    L = nets.loss
    gmain = jit_with_draws(lambda pg, pd, pds, batch, z, c, key: jax.value_and_grad(
        lambda p: L.g_main(p, pd, pds, batch, z, c, key, BLUR, NRR), has_aux=True)(pg))
    batch, gen_z, gen_c = make_batch(seed=8, b=1)
    return nets, {"gmain": gmain}, batch, gen_z, gen_c


def test_g_main_through_the_frustum_renderer_matches_jax(setup, shared_draws):
    """The random pose, no cross-view term (one render)."""
    nets, fns, batch, gen_z, gen_c = setup
    P = nets.params
    key = coin_key(1.0, start=800)
    ((value, _), grads), draws = fns["gmain"](
        P["G"], P["D"], P["D_semantic"], _jb(batch), gen_z[0], gen_c[0], key)
    tb, z, c = to_torch(batch), torch.from_numpy(gen_z[0]), torch.from_numpy(gen_c[0])
    shared_draws.extend(draws)
    got, _, tgrads = port_value_and_grad(
        lambda: nets.tloss.g_main(tb, z, c, torch.Generator(), BLUR, NRR),
        nets.tG, list(nets.modules().values()))
    assert_loss_close(got, value)
    assert_grads_close(tgrads, grads, "g_main (frustum)")
    assert all(torch.isfinite(g).all() for g in tgrads.values())


def _render_grads(planes, decoder, c2w, intr, remat):
    """The loss of tests/test_frustum.py::test_frustum_render_is_differentiable
    through the port's renderer, its gradients w.r.t. the planes and the
    decoder, and the bytes the forward saved for the backward."""
    opts = dict(RENDER_OPTS, frustum_remat=remat)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    planes = planes.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        feats, depth, w = tfr.frustum_render(planes, decoder, c2w, intr, opts, 16,
                                             depth_steps=32, chunk=8)
    loss = feats.square().mean() + w.mean() + depth.mean() * 1e-2
    params = [planes] + list(decoder.parameters())
    return loss.detach(), torch.autograd.grad(loss, params), sum(saved)


@pytest.fixture(scope="module")
def render_case():
    from test_torch_render import _camera, _decoder, _planes, t
    jd, params, td = _decoder(False, 9)
    td.requires_grad_(True)
    c2w, intr = _camera(np.pi / 2 + 0.2, np.pi / 2 - 0.1, batch=2)
    planes = _planes(2, seed=4)
    return jd, params, td, t(planes), t(c2w), t(intr), (planes, c2w, intr)


def test_frustum_render_gradients_match_jax(render_case):
    jd, params, td, planes, c2w, intr, (jplanes, jc2w, jintr) = render_case

    def loss_fn(planes, dp):
        feats, depth, w = jfr.frustum_render(planes, lambda f, d: jd(dp, f, d), jc2w,
                                             jintr, RENDER_OPTS, 16, depth_steps=32,
                                             chunk=8)
        return (jnp.mean(jnp.square(feats)) + jnp.mean(w)
                + jnp.mean(depth) * 1e-2)

    value, (gp, gd) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        jnp.asarray(jplanes), params)
    got, grads, _ = _render_grads(planes, td, c2w, intr, True)
    assert_loss_close(got, value)
    gp = np.asarray(gp)
    assert np.abs(grads[0].numpy() - gp).max() <= 1e-3 * np.abs(gp).max() + 1e-6
    names = [k for k, _ in td.named_parameters()]
    assert_grads_close(dict(zip(names, grads[1:])), gd, "decoder")


def test_frustum_remat_on_and_off_give_the_same_gradients(render_case):
    _, _, td, planes, c2w, intr, _ = render_case
    v_on, g_on, saved_on = _render_grads(planes, td, c2w, intr, True)
    v_off, g_off, saved_off = _render_grads(planes, td, c2w, intr, False)
    assert torch.equal(v_on, v_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    # with remat a chunk keeps only the carry, not its slab features,
    # decoder activations and colors: at least the features and colors of
    # every sample go (the sheared textures are kept either way)
    n, T, r = planes.shape[0], 32, 16 * 16
    assert saved_off - saved_on >= n * T * r * (32 + 64) * 4, (saved_on, saved_off)


def test_frustum_remat_changes_nothing_without_gradients(render_case):
    _, _, td, planes, c2w, intr, _ = render_case
    with torch.no_grad():
        outs = [tfr.frustum_render(planes, td, c2w, intr,
                                   dict(RENDER_OPTS, frustum_remat=remat), 16,
                                   depth_steps=32, chunk=8) for remat in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
