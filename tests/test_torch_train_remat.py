"""`remat=True` (`torch.utils.checkpoint` of `run_G`, JAX's
`jax.checkpoint(run_G)`) against the plain step and against the JAX
package's remat phase.

The recompute in the backward pass must draw the numbers the forward drew.
The port draws from an explicit `torch.Generator`, which the checkpoint's
`preserve_rng_state` does not restore; `loss._replay_generator` gives the
recompute a copy of the generator as it stood before the forward.

- One whole `Trainer.step` (cross-view renders, Gmain, Dmain, D_semantic
  main, EMA) with remat equals the step without it bit for bit on the CPU,
  from the same weights and generator seed: the recompute repeats the
  forward exactly.
- `g_main` with remat on JAX's draws equals JAX's remat `g_main` (loss
  1e-4 relative, per-leaf gradients 1e-3 of the leaf's largest + 1e-6, the
  tolerances of tests/test_torch_train_phases.py).  Here the draw hooks
  hand out JAX's draws keyed by the generator's state at the call
  (`keyed_draws`): a recompute from the restored state gets the forward's
  draws again, one from any other state takes new ones.
- Mutation check: with `_replay_generator` handing the recompute the live
  generator (not restored), the step is no longer bit-equal, and the JAX
  comparison meets draws JAX never made.
"""

import numpy as np
import pytest
import torch

import jax

from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.nn import synthesis as tsyn
from pix2pix3d_tpu_torch.render import renderer as trenderer
from pix2pix3d_tpu_torch.train import loss as tloss
from pix2pix3d_tpu_torch.train.trainer import Trainer

from test_torch_train_phases import (assert_grads_close, assert_loss_close,
                                     BLUR, coin_key, jax_phase_fns, _jb,
                                     make_batch, Nets, NRR,
                                     port_value_and_grad, to_torch,
                                     two_torch_threads)

__all__ = ["two_torch_threads"]


@pytest.fixture
def keyed_draws(monkeypatch):
    """A queue of JAX draws [(kind, array)] that the port's draw hooks hand
    out keyed by the state of the generator they are given (each call then
    advances that generator by one draw): the same state gets the same
    draw, a new state the next one from the queue."""
    queue, seen = [], {}

    def take(kind, shape, generator):
        key = generator.get_state().numpy().tobytes()
        torch.rand((), generator=generator)
        if key not in seen:
            assert queue, f"the port drew more than the JAX package ({kind} {shape})"
            seen[key] = queue.pop(0)
        got_kind, arr = seen[key]
        assert got_kind == kind and tuple(arr.shape) == tuple(shape), \
            (kind, tuple(shape), got_kind, arr.shape)
        return torch.from_numpy(np.array(arr, np.float32))

    def noise(shape, generator, device):
        n, _, h, w = shape
        return take("normal", (n, h, w, 1), generator).permute(0, 3, 1, 2) \
            .contiguous().to(device)

    monkeypatch.setattr(tsyn, "draw_noise", noise)
    monkeypatch.setattr(trenderer, "_uniform",
                        lambda g, shape, device: take("uniform", shape, g).to(device))
    monkeypatch.setattr(tloss, "draw_uniform",
                        lambda g, shape, device: take("uniform", shape, g).to(device))
    monkeypatch.setattr(tloss, "draw_normal",
                        lambda g, shape, device: take("normal", shape, g).to(device))
    monkeypatch.setattr(tdisc, "draw_normal",
                        lambda g, shape, device: take("normal", shape, g).to(device))
    return queue


def not_restored(generator, state):
    """The mutation: the recompute draws from the live generator."""
    return generator


@pytest.fixture(scope="module")
def nets():
    return Nets(loss_kw={"remat": True})


def _step(nets, remat, batch, gen_z, gen_c):
    nets.load_port(nets.params)
    nets.tloss.remat = remat
    trainer = Trainer(nets.tloss)
    stats = trainer.step(to_torch(batch), torch.from_numpy(gen_z),
                         torch.from_numpy(gen_c), torch.Generator().manual_seed(11),
                         step_idx=1, cur_nimg=0, batch_size=gen_z.shape[1])
    return stats, {k: v.detach().clone() for k, v in trainer.G.state_dict().items()}, \
        trainer.state_tree()


def _bit_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_remat_step_equals_the_plain_step_bit_for_bit(nets, monkeypatch):
    batch, gen_z, gen_c = make_batch(seed=6)
    s_plain, g_plain, _ = _step(nets, False, batch, gen_z, gen_c)
    s_remat, g_remat, _ = _step(nets, True, batch, gen_z, gen_c)
    assert set(s_plain) == set(s_remat)
    for k in s_plain:
        assert np.array_equal(s_plain[k], s_remat[k]), k
    assert _bit_equal(g_plain, g_remat)
    # mutation: a recompute on new draws gives other gradients, another G
    monkeypatch.setattr(tloss, "_replay_generator", not_restored)
    _, g_bad, _ = _step(nets, True, batch, gen_z, gen_c)
    assert not _bit_equal(g_plain, g_bad)
    nets.load_port(nets.params)


@pytest.fixture(scope="module")
def jax_remat_g_main(nets):
    """JAX's remat g_main (value, gradients) and its draws, recorded on its
    plain run_G (recording inside jax.checkpoint would leak its tracers;
    remat changes no key), with the inputs."""
    fns = jax_phase_fns(nets)
    P = nets.params
    batch, gen_z, gen_c = make_batch(seed=7)
    key = coin_key(0.0, start=700)
    remat_run_G = nets.loss.run_G
    del nets.loss.run_G
    try:
        cv, _ = fns["cv_prep"](P["G"], _jb(batch), gen_z[0], gen_c[0], key)
        args = (P["G"], P["D"], P["D_semantic"], _jb(batch), gen_z[0], gen_c[0],
                key, cv)
        ((plain_value, _), _), draws = fns["gmain"](*args)
    finally:
        nets.loss.run_G = remat_run_G
    L = nets.loss
    (value, _), grads = jax.jit(lambda pg, pd, pds, b, z, c, k, cv: jax.value_and_grad(
        lambda p: L.g_main(p, pd, pds, b, z, c, k, BLUR, NRR, cv_aux=cv),
        has_aux=True)(pg))(*args)
    assert_loss_close(value, plain_value)
    return value, grads, draws, batch, gen_z, gen_c, cv


def _port_remat_g_main(nets, keyed_draws, jax_out):
    value, grads, draws, batch, gen_z, gen_c, cv = jax_out
    keyed_draws.extend(draws)
    tcv = {k: torch.from_numpy(np.asarray(v)) for k, v in cv.items()}
    nets.load_port(nets.params)
    nets.tloss.remat = True
    got, _, tgrads = port_value_and_grad(
        lambda: nets.tloss.g_main(to_torch(batch), torch.from_numpy(gen_z[0]),
                                  torch.from_numpy(gen_c[0]),
                                  torch.Generator().manual_seed(5), BLUR, NRR,
                                  cv_aux=tcv),
        nets.tG, list(nets.modules().values()))
    assert not keyed_draws, f"the port drew {len(keyed_draws)} fewer numbers than JAX"
    assert_loss_close(got, value)
    assert_grads_close(tgrads, grads, "g_main (remat)")


def test_remat_g_main_matches_jax_remat(nets, jax_remat_g_main, keyed_draws,
                                        monkeypatch):
    assert "run_G" in vars(nets.loss)   # JAX's loss checkpointed its run_G
    _port_remat_g_main(nets, keyed_draws, jax_remat_g_main)
    # mutation: without the restored generator the recompute asks for draws
    # JAX never made (the check of each draw's kind and shape, or of the
    # queue, fails)
    monkeypatch.setattr(tloss, "_replay_generator", not_restored)
    keyed_draws.clear()
    with pytest.raises(AssertionError):
        _port_remat_g_main(nets, keyed_draws, jax_remat_g_main)
