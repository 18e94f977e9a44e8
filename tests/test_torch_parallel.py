"""The port's data-parallel training (`pix2pix3d_tpu_torch/parallel/`)
against the JAX package's, on the CPU:

- `local_batch_slice` and the rank and world arithmetic of `--num-nodes`/
  `--node-rank` against JAX's `local_batch_slice` (its process count and
  index set as a multi-host run sets them), and the divisibility error;
- the trainer's reductions (the flat gradient of a phase, the stat moments,
  the D phase's ws mean) over 2 and 4 gloo ranks against JAX's `shard_map`
  `pmean`/`psum` on as many of the suite's virtual CPU devices, bit for bit
  (each sum is over the same few values, and dividing by 2 or 4 is exact);
- one whole `Trainer.step` at world size 2 (two gloo ranks, the small
  width of tests/test_torch_train_phases.py, global batch 4, 1 round)
  against the JAX package's 2-device step composed from its jitted phases
  (tests/test_torch_train_step.py's `jax_reference_step` with `shards=2`:
  each shard on its rows with its device-folded key, the mean of the
  shards' gradients, the sum of their moments), with that file's
  tolerances (its docstring states them and why) but one: w_avg within
  1e-4 of its largest entry, where that file takes 1e-4 of each entry.
  w_avg starts at 0, so after the step it is 0.005 x the batch-mean ws,
  and its entries near 0 carry the rounding of the encoder and mapping at
  the size of the largest: on this batch 3 of 7168 entries lie within
  2.5e-7 of JAX's (1.5e-5 of the largest ws) but above 1e-4 of their own
  size.  Both ranks' states and stats must be equal bit for bit;
- the CLI's launcher: a rank that raises ends its node's other ranks, also
  one waiting in a collective, and the launch raises.

The ranks of the step run as threads of this process, each with its own
gloo group on one `HashStore`, so the port's draw hooks can hand each rank
its shard's JAX draws (a queue per thread).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import copy
import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh, PartitionSpec as P

from pix2pix3d_tpu.parallel import multihost as jmultihost

from pix2pix3d_tpu_torch.parallel import multihost
from pix2pix3d_tpu_torch.parallel.trainer import Trainer, mean_over_ranks, reduce_gradients

from test_torch_train_phases import (Nets, install_draw_hooks, jax_phase_fns,
                                     make_batch, take_from, to_torch,
                                     two_torch_threads)
from test_torch_train_step import check_step, jax_reference_step

__all__ = ["two_torch_threads"]

# a rank waits this long in a collective before it raises: a failing rank
# ends the test instead of hanging it
TIMEOUT = datetime.timedelta(seconds=300)


def run_ranks(world, fn):
    """`fn(rank, group)` on `world` threads, each with its own gloo group on
    one `HashStore`; returns their results in rank order and raises the
    first rank's exception."""
    store = dist.HashStore()
    results, errors = [None] * world, [None] * world

    def main(rank):
        try:
            results[rank] = fn(rank, dist.ProcessGroupGloo(store, rank, world, TIMEOUT))
        except BaseException as e:  # re-raised below
            errors[rank] = e

    threads = [threading.Thread(target=main, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * TIMEOUT.total_seconds())
        assert not t.is_alive(), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results


# --- (a) the rank arithmetic -------------------------------------------------

@pytest.mark.parametrize("batch,nodes,local", [(4, 1, 1), (8, 1, 4), (8, 2, 2),
                                               (32, 2, 8), (12, 3, 2)])
def test_rank_slices_match_jax(monkeypatch, batch, nodes, local):
    """Node i's ranks, in local-rank order, cover exactly JAX's host slice
    of node i (`jax.process_count()` = nodes, `process_index()` = i), each
    rank its own rows in the order of JAX's device mesh."""
    world = nodes * local
    for node in range(nodes):
        monkeypatch.setattr(jax, "process_count", lambda: nodes)
        monkeypatch.setattr(jax, "process_index", lambda node=node: node)
        lo, hi = jmultihost.local_batch_slice(batch)
        rows = []
        for lr in range(local):
            rank, w = multihost.world_layout(nodes, node, local, lr)
            assert (rank, w) == (node * local + lr, world)
            start, stop = multihost.local_batch_slice(batch, rank, world)
            assert stop - start == batch // world
            rows += range(start, stop)
        assert rows == list(range(lo, hi))


def test_rank_slices_refuse_what_jax_refuses(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    with pytest.raises(AssertionError):
        jmultihost.local_batch_slice(8)
    with pytest.raises(ValueError, match="batch_size 8 must divide over 3 devices"):
        multihost.local_batch_slice(8, 0, 3)
    for args in ((2, 2, 1, 0), (2, 0, 1, 1), (0, 0, 1, 0)):
        with pytest.raises(ValueError):
            multihost.world_layout(*args)
    # one process, no group: rank 0 of 1, the whole batch; no rendezvous
    assert multihost.local_batch_slice(6) == (0, 6)
    assert multihost.initialize_multihost("localhost:1", 1, 0, device="cpu") is None
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for("cuda:1") == "nccl"


# --- (b) the reductions against shard_map -------------------------------------

def _rank_trees(world, seed=0):
    """Per rank: a gradient tree (a zero leaf, as a phase gives a parameter
    it does not reach; NaN and infinities on some ranks), a stats vector and
    a ws mean."""
    rng = np.random.RandomState(seed)
    sign = np.sign(rng.randn(7)).astype(np.float32)
    trees = []
    for r in range(world):
        # "d": near the top of f32, one sign per entry on every rank, so
        # that a sum overflows (or not) in any order
        g = {"a": rng.randn(3, 4).astype(np.float32) * 1e3,
             "b": rng.randn(5).astype(np.float32),
             "c": np.zeros((2, 2, 2), np.float32),
             "d": sign * (1 + np.abs(rng.randn(7)).astype(np.float32)) * 1e38}
        g["b"][r % 5] = [np.nan, np.inf, -np.inf, 1.0, 2.0][r % 5]
        trees.append({"grads": g, "stats": rng.randn(12).astype(np.float32),
                      "ws": rng.randn(4, 8).astype(np.float32)})
    return trees


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("gain", [1.0, 16.0])
def test_reductions_match_shard_map(world, gain):
    trees = _rank_trees(world, seed=world)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))

    def device(tree):  # one device's body, as JAX's trainer reduces
        tree = jax.tree_util.tree_map(lambda x: x[0], tree)
        flat, _ = ravel_pytree(tree["grads"])
        flat = jax.lax.pmean(flat * gain, "data")
        flat = jnp.nan_to_num(flat, nan=0.0, posinf=1e5, neginf=-1e5)
        return (flat, jax.lax.psum(tree["stats"], "data"),
                jax.lax.pmean(tree["ws"], "data"))

    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)
    want = jax.jit(jax.shard_map(device, mesh=mesh, in_specs=(P("data"),),
                                 out_specs=(P(), P(), P()), check_vma=False))(stacked)
    want = [np.asarray(w) for w in want]

    def rank(r, group):
        tree = trees[r]
        names = sorted(tree["grads"])  # ravel_pytree's order
        grads = reduce_gradients([torch.from_numpy(tree["grads"][k]) for k in names],
                                 gain, group)
        for k, g in zip(names, grads):
            assert g.shape == tree["grads"][k].shape
        stats = multihost.all_reduce_sum_(torch.from_numpy(tree["stats"].copy()), group)
        ws = mean_over_ranks(torch.from_numpy(tree["ws"]), group)
        return torch.cat([g.reshape(-1) for g in grads]).numpy(), stats.numpy(), ws.numpy()

    # each term as both sides add it, for the rounding bound of the sum
    terms = [np.stack([np.concatenate([t["grads"][k].reshape(-1).astype(np.float64) * gain
                                       for k in sorted(t["grads"])]) for t in trees]),
             np.stack([t["stats"] for t in trees]), np.stack([t["ws"] for t in trees])]
    for got in run_ranks(world, rank):
        for g, w, x in zip(got, want, terms):
            if world == 2:     # one addition, the same in any order
                np.testing.assert_array_equal(g, w)
                continue
            # gloo and XLA add the terms in other orders: (world - 1)
            # roundings of partial sums; the infinities and NaN of nan_to_num
            # and overflow exactly
            bound = (world - 1) * np.finfo(np.float32).eps * np.abs(x.astype(np.float64)).sum(0)
            bound = bound.reshape(w.shape) / (world if x is not terms[1] else 1)
            finite = np.isfinite(bound) & np.isfinite(w)
            np.testing.assert_array_equal(g[~finite], w[~finite])
            assert np.all(np.abs(g - w)[finite] <= bound[finite])
    zero = slice(12 + 5, 12 + 5 + 8)   # leaf "c": zero gradients stay zero
    assert not want[0][zero].any()


# --- (c) one whole step at world size 2 --------------------------------------

@pytest.fixture(scope="module")
def setup():
    nets = Nets()
    return nets, jax_phase_fns(nets)


@pytest.fixture
def rank_draws(monkeypatch):
    """The port's draw hooks, each thread taking from its own queue of JAX
    draws (`rank_draws.queue`, set by the thread)."""
    local = threading.local()
    install_draw_hooks(monkeypatch,
                       lambda kind, shape: take_from(local.queue, kind, shape))
    return local


def test_world_two_step_matches_the_jax_two_device_step(setup, rank_draws):
    nets, fns = setup
    world, b = 2, 4
    batch, gen_z, gen_c = make_batch(seed=5, b=b)
    state, stats, phase_grads, draws = jax_reference_step(
        nets, fns, batch, gen_z, gen_c, jax.random.PRNGKey(11), 1, shards=world)
    nets.load_port(nets.params)
    tbatch = to_torch(batch)

    def rank(r, group):
        trainer = Trainer(copy.deepcopy(nets.tloss), process_group=group)
        trainer.G_ema.load_state_dict(trainer.G.state_dict())
        trainer.sync_replicas()
        start, stop = multihost.local_batch_slice(b, r, world)
        rank_draws.queue = list(draws[r])
        tstats = trainer.step({k: v[start:stop] for k, v in tbatch.items()},
                              torch.from_numpy(gen_z[:, start:stop]),
                              torch.from_numpy(gen_c[:, start:stop]),
                              torch.Generator(), step_idx=0, cur_nimg=0, batch_size=b)
        assert not rank_draws.queue, f"rank {r} drew fewer numbers than its shard"
        return trainer, tstats, int(trainer.replica_checksum())

    (t0, s0, c0), (t1, s1, c1) = run_ranks(world, rank)
    check_step(nets, t0, s0, state, stats, phase_grads, w_avg_of_leaf=True)
    assert set(s0) == set(s1) and all(np.array_equal(s0[k], s1[k]) for k in s0)
    assert c0 == c1
    for (name, (m0, o0)), (_, (m1, o1)) in zip(t0.networks().items(),
                                               t1.networks().items()):
        for (k, v0), v1 in zip(m0.state_dict().items(), m1.state_dict().values()):
            assert torch.equal(v0, v1), (name, k)
        if o0 is not None:
            for p0, p1 in zip(m0.parameters(), m1.parameters()):
                for k in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(o0.state[p0][k], o1.state[p1][k]), (name, k)


# --- the launcher --------------------------------------------------------------

def test_a_failing_rank_ends_the_launch():
    """The CLI's launcher (`multihost.spawn_ranks`): rank 1 raises while
    rank 0 waits for it in a collective; rank 0 is ended and the launch
    raises, well before the group's timeout."""
    import time

    import torch_parallel_ranks
    t0 = time.time()
    with pytest.raises((torch.multiprocessing.ProcessRaisedException,
                        torch.multiprocessing.ProcessExitedException)):
        multihost.spawn_ranks(torch_parallel_ranks.fail_on_rank_one, 2,
                              f"localhost:{multihost.free_port()}")
    assert time.time() - t0 < 60


def test_the_cli_spawns_a_function_a_new_process_imports():
    """`python -m pix2pix3d_tpu_torch.train` runs a package's `__main__`,
    whose functions a spawned process cannot load (multiprocessing does not
    run such a module again): the launcher spawns `train.loop.train_rank`,
    which a fresh interpreter loads by its name."""
    import os
    import pickle
    import subprocess
    import sys

    from pix2pix3d_tpu_torch.train import loop
    code = ("import pickle, sys; "
            "print(pickle.loads(sys.stdin.buffer.read()).__module__)")
    out = subprocess.run([sys.executable, "-c", code], input=pickle.dumps(loop.train_rank),
                         capture_output=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.decode().strip() == "pix2pix3d_tpu_torch.train.loop"
