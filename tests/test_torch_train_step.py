"""One whole `Trainer.step` of the port at step_idx 0 (every phase: the
cross-view renders, Gmain, Greg, Dmain with the w_avg update, Dreg,
D_semantic main and reg, the EMA) against a reference composed here from
the JAX package's phases (tests/test_torch_train_phases.py's jitted
`jax_phase_fns`), its `_lazy_adam`, `_nan_to_num`, `ema_update` and
`copy_buffers`, in the order and with the key derivation of
`pix2pix3d_tpu/parallel/trainer.py` `_device_step` on one device; with 1
accumulation round over a batch of 2 and with 2 rounds over a batch of 4
(micro-batches of 2, so both cases run the same compiled JAX phases).  The
monolithic jitted JAX step is not used: its compile takes ~19 minutes on
this CPU (tests/test_train_step.py is marked slow).

Tolerances (the reasons):
- every stat's [count, sum, sum of squares]: 1e-4 relative, 1e-6 absolute
  (f32 losses and logits, summation orders differ);
- Adam's mu (the last gradient, b1 = 0) per leaf: 1e-3 * max |mu_jax| + 1e-6
  as the gradients in tests/test_torch_train_phases.py; nu (squared
  gradients): 2e-3 * max |nu_jax| + 1e-12; the count exactly;
- parameters after the step (G, D, D_semantic, G_ema), only above each
  gradient's noise floor (`_compare_mask`): an entry one phase updated,
  where |g_jax| is above twice its tolerance, to 1e-6; an entry two phases
  updated (Gmain and Greg, Dmain and Dreg), where both are above 100 times
  it, to 5e-5.  The first Adam step with b1 = 0 moves an entry by about
  lr * g / (|g| + eps), so below the floor the sign of a gradient that is
  rounding noise decides a whole lr; at least 1% of each network's
  entries must be compared (gradients are heavy-tailed: most entries sit
  far below their leaf's largest);
- w_avg after the D phase: 1e-4 relative (the batch-mean ws).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2pix3d_tpu.parallel.trainer import _lazy_adam, _nan_to_num
from pix2pix3d_tpu.train.ema import copy_buffers, ema_update
import optax

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.parallel.trainer import Trainer

from test_torch_train_phases import (jax_phase_fns, make_batch, Nets,
                                     shared_draws, to_torch, two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]

W_AVG_BETA = 0.995
OPTS = {"G": _lazy_adam(0.0025, (0.0, 0.99), 1e-8, 4),
        "D": _lazy_adam(0.002, (0.0, 0.99), 1e-8, 16),
        "D_semantic": _lazy_adam(0.002, (0.0, 0.99), 1e-8, 16)}


@pytest.fixture(scope="module")
def setup():
    nets = Nets()
    return nets, jax_phase_fns(nets)


def _mb(tree, r, rounds):
    if rounds == 1:
        return tree
    n = next(iter(tree.values())).shape[0] // rounds
    return {k: v[r * n:(r + 1) * n] for k, v in tree.items()}


# the reference's tree arithmetic, each one jitted program (eagerly, each op
# of each leaf shape would compile a program of its own: a minute per process)
_tree_add = jax.jit(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b))
_adam_init = jax.jit(lambda net, p: OPTS[net].init(p), static_argnums=0)
_ema = jax.jit(lambda p: copy_buffers(ema_update(jax.tree_util.tree_map(jnp.copy, p),
                                                 p, 0.0), p))


def _add(a, b):
    return b if a is None else _tree_add(a, b)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _phase_adam(net, grads, gain, opt_state, params):
    """The phase's update on a mesh of len(grads) devices: `pmean(grad *
    gain)` (the sum over the shards divided by their number), `nan_to_num`,
    one Adam step.  Returns (the gradient, Adam's state, the parameters)."""
    grads = jax.tree_util.tree_map(
        lambda *g: functools.reduce(jnp.add, [x * gain for x in g]) / len(g), *grads)
    grads = _nan_to_num(grads)
    upd, opt_state = OPTS[net].update(grads, opt_state, params)
    return grads, opt_state, optax.apply_updates(params, upd)


def jax_reference_step(nets, fns, batch, gen_z, gen_c, key, rounds, shards=1):
    """The JAX trainer's step at step_idx 0, phase by phase.  Returns the
    state, the stats (summed moments), each network's per-phase gradients,
    and the draws in the order they were made.

    With `shards` > 1, the step of a `shards`-device mesh (`_device_step`
    under `shard_map`): shard i takes rows [i * n, (i + 1) * n) of the batch
    and the same columns of the phase inputs and folds the key with i; each
    phase's gradient is the `pmean` of `grad * gain` over the shards (their
    sum divided by `shards`), the D phase's ws mean is averaged over them and
    the stats are summed.  The draws are then one list per shard."""
    P = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in nets.params.items()}
    opt_state = {k: _adam_init(k, P[k]) for k in OPTS}
    n = batch["pose"].shape[0] // shards
    cols = [slice(i * n, (i + 1) * n) for i in range(shards)]
    rngs = [jax.random.split(jax.random.fold_in(key, i), 6) for i in range(shards)]
    jb = [{k: jnp.asarray(v[c]) for k, v in batch.items()} for c in cols]
    z = [[{"z": jnp.asarray(gen_z[p, c]), "c": jnp.asarray(gen_c[p, c])}
          for p in range(4)] for c in cols]
    draws, stats, phase_grads = [[] for _ in cols], {}, {k: [] for k in OPTS}

    def update(net, grads, gain):
        grads, opt_state[net], P[net] = _phase_adam(net, grads, gain, opt_state[net],
                                                    P[net])
        phase_grads[net].append(jax.device_get(grads))

    def add_stats(s):
        for k, v in s.items():
            stats[k] = stats.get(k, 0) + np.asarray(v)

    cv_aux = []
    for i in range(shards):
        cvs = []
        for r in range(rounds):
            b, zc = _mb(jb[i], r, rounds), _mb(z[i][0], r, rounds)
            cv, d = fns["cv_prep"](P["G"], b, zc["z"], zc["c"],
                                   jax.random.fold_in(rngs[i][0], r))
            cvs.append(cv)
            draws[i] += d
        cv_aux.append({k: jnp.concatenate([c[k] for c in cvs]) for k in cvs[0]})

    def run(name, net, args_fn, gain, ws=False):
        per_shard, ws_means = [], []
        for i in range(shards):
            grads = ws_mean = None
            for r in range(rounds):
                ((_, aux), g), d = fns[name](*args_fn(i, r))
                draws[i].extend(d)
                grads = _add(grads, g)
                if ws:
                    aux, extra = aux
                    ws_mean = _add(ws_mean, jnp.mean(extra["ws"], axis=0) / rounds)
                add_stats(aux)
            per_shard.append(grads)
            ws_means.append(ws_mean)
        update(net, per_shard, gain)
        return functools.reduce(jnp.add, ws_means) / shards if ws else None

    def inputs(i, p, r):
        return _mb(jb[i], r, rounds), _mb(z[i][p], r, rounds)

    def gmain(i, r):
        b, zc = inputs(i, 0, r)
        return (P["G"], P["D"], P["D_semantic"], b, zc["z"], zc["c"],
                jax.random.fold_in(rngs[i][0], r), _mb(cv_aux[i], r, rounds))
    run("gmain", "G", gmain, 1.0)
    run("greg", "G", lambda i, r: (P["G"], inputs(i, 1, r)[0], inputs(i, 1, r)[1]["z"],
                                   jax.random.fold_in(rngs[i][1], r)), 4.0)

    def dmain(i, r):
        b, zc = inputs(i, 2, r)
        return (P["D"], P["G"], b, zc["z"], zc["c"], jax.random.fold_in(rngs[i][2], r))
    ws_mean = run("dmain", "D", dmain, 1.0, ws=True)
    mp = P["G"]["backbone"]["mapping"]
    mp["w_avg"] = ws_mean + W_AVG_BETA * (mp["w_avg"] - ws_mean)
    run("dreg", "D", lambda i, r: (P["D"], inputs(i, 0, r)[0],
                                   jax.random.fold_in(rngs[i][3], r)), 16.0)

    def dsmain(i, r):
        b, zc = inputs(i, 3, r)
        return (P["D_semantic"], P["G"], b, zc["z"], zc["c"],
                jax.random.fold_in(rngs[i][4], r))
    run("dsmain", "D_semantic", dsmain, 1.0)
    run("dsreg", "D_semantic", lambda i, r: (P["D_semantic"], inputs(i, 0, r)[0],
                                             jax.random.fold_in(rngs[i][5], r)), 16.0)
    state = dict(jax.device_get(P), G_ema=jax.device_get(_ema(P["G"])))
    for k in OPTS:
        state[f"opt_{k}"] = jax.device_get(opt_state[k])
    return state, stats, phase_grads, (draws[0] if shards == 1 else draws)


def _compare_mask(grads_list):
    """{leaf: (entries to compare, their tolerance)}.  An entry updated by
    one phase (g_jax != 0 in one phase only) is compared where |g_jax| is
    above twice its tolerance: the step is then lr * sign(g), to 1e-6.  An
    entry updated by two phases is compared where both |g_jax| are above
    100 times their tolerance: the second step divides by sqrt(nu) over
    both gradients, so 1% relative gradient error moves it by up to
    2 * lr * 1% < 5e-5."""
    ratio, n_phases = {}, {}
    for g in grads_list:
        for k, v in bridge.params_from_jax(g).items():
            a = np.abs(v.numpy())
            r = np.where(a == 0, np.inf, a / (1e-3 * a.max() + 1e-6))
            ratio[k] = np.minimum(ratio.get(k, np.inf), r)
            n_phases[k] = n_phases.get(k, 0) + (a != 0)
    out = {}
    for k in ratio:
        once = n_phases[k] <= 1
        mask = np.where(once, ratio[k] > 2, ratio[k] > 100) & (n_phases[k] > 0)
        out[k] = (mask, np.where(once, 1e-6, 5e-5)[mask])
    return out


def check_step(nets, trainer, tstats, state, stats, phase_grads, w_avg_of_leaf=False):
    """The port's step (its trainer and returned stats) against the JAX
    reference's, with the tolerances of the module docstring; with
    `w_avg_of_leaf`, w_avg within 1e-4 of its largest entry (+ 1e-7)
    instead of each entry's own size."""
    assert set(tstats) == set(stats)
    for k in stats:
        np.testing.assert_allclose(tstats[k], stats[k], rtol=1e-4, atol=1e-6, err_msg=k)

    got = trainer.state_tree()
    w_avg = state["G"]["backbone"]["mapping"]["w_avg"]
    np.testing.assert_allclose(got["G"]["backbone"]["mapping"]["w_avg"], w_avg,
                               rtol=0 if w_avg_of_leaf else 1e-4,
                               atol=(1e-4 * np.abs(w_avg).max() if w_avg_of_leaf else 0)
                               + 1e-7)
    for net in ("G", "D", "D_semantic"):
        adam = bridge.params_from_jax(got[f"opt_{net}"]["0"]["mu"]), \
            bridge.params_from_jax(got[f"opt_{net}"]["0"]["nu"])
        jadam = state[f"opt_{net}"][0]
        assert int(got[f"opt_{net}"]["0"]["count"]) == int(jadam.count) == len(phase_grads[net])
        for t, j, scale in ((adam[0], jadam.mu, 1e-3), (adam[1], jadam.nu, 2e-3)):
            want = bridge.params_from_jax(j)
            for k, v in t.items():
                w = want[k].numpy()
                err = np.abs(v.numpy() - w).max()
                assert err <= scale * np.abs(w).max() + (1e-6 if scale == 1e-3 else 1e-12), \
                    (net, k, float(err))
        mask = _compare_mask(phase_grads[net])
        for key in ((net, "G_ema") if net == "G" else (net,)):
            gp = bridge.params_from_jax(got[key])
            jp = bridge.params_from_jax(state[key])
            params = dict(nets.modules()[net].named_parameters())
            compared = total = 0
            for k in params:
                m, tol = mask[k]
                compared += int(m.sum())
                total += m.size
                err = np.abs(gp[k].numpy()[m] - jp[k].numpy()[m])
                assert np.all(err <= tol), (key, k, float((err - tol).max()))
            assert compared >= total / 100, (key, compared, total)
    # step 0: the EMA's beta is 0, so G_ema is G
    G = trainer.G.state_dict()
    for k, v in trainer.G_ema.state_dict().items():
        assert torch.equal(v, G[k]), k


@pytest.mark.parametrize("rounds", [1, 2])
def test_trainer_step_matches_the_jax_phases(setup, shared_draws, rounds):
    nets, fns = setup
    b = 2 * rounds
    batch, gen_z, gen_c = make_batch(seed=5, b=b)
    state, stats, phase_grads, draws = jax_reference_step(
        nets, fns, batch, gen_z, gen_c, jax.random.PRNGKey(11), rounds)

    nets.load_port(nets.params)
    trainer = Trainer(nets.tloss, grad_accum_rounds=rounds)
    trainer.G_ema.load_state_dict(nets.tG.state_dict())
    shared_draws.extend(draws)
    tstats = trainer.step(to_torch(batch), torch.from_numpy(gen_z),
                          torch.from_numpy(gen_c), torch.Generator(), step_idx=0,
                          cur_nimg=0, batch_size=b)
    check_step(nets, trainer, tstats, state, stats, phase_grads)
