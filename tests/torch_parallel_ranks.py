"""Rank functions that tests/test_torch_parallel.py spawns: a module of its
own, so that the spawned processes import torch and the port only."""

import datetime

import torch

from pix2pix3d_tpu_torch.parallel import multihost


def fail_on_rank_one(rank, coordinator):
    """Rank 1 raises after the rendezvous; rank 0 waits for it in a
    collective (until the launcher ends it, or the group's timeout)."""
    group = multihost.initialize_multihost(coordinator, 2, rank, device="cpu",
                                           timeout=datetime.timedelta(seconds=60))
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    multihost.all_reduce_sum_(torch.zeros(1), group)
