"""Multi-card and multi-node start-up on `torch.distributed`, port of
`pix2pix3d_tpu/parallel/multihost.py`.

The JAX package runs one process per host with every local chip in one
mesh.  The port runs one process per card, as the reference does
(`train.py:33-113`): NCCL between cards, gloo on the CPU.  Ranks are
numbered node by node, global rank = node rank x cards per node + local
rank, which is the device order `make_data_mesh` sorts to.

The JAX functions that return mesh objects have no PyTorch object to
return.  What stands in for each:
- `make_data_mesh`: the world process group that `initialize_multihost`
  joins; its one axis is the rank.
- `make_hybrid_mesh`: the same group.  Data parallelism needs no (hosts,
  local cards) grid: NCCL routes within a node over NVLink and across nodes
  over the network by itself.
- `shard_host_batch`: each rank keeps rows [start, stop) of the global
  batch (`local_batch_slice`) on its own card; there is no global array.

Usage, one command per node (the CLI spawns one process per card):

    python -m pix2pix3d_tpu_torch.train ... --num-nodes 2 --node-rank $i \\
        --coordinator node0:29500

The collectives below take the group as an argument and run on any
`torch.distributed` group, also one built directly on a store (as the CPU
tests build one per thread).
"""

from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

# how long a rank waits in a collective (or the rendezvous) for the others
# before it raises: long enough for rank 0's image snapshot and checkpoint
# write at full width, short enough that a lost rank ends the run
DEFAULT_TIMEOUT = datetime.timedelta(minutes=15)


def backend_for(device):
    """The collective backend for `device`: NCCL for a card, gloo for the
    CPU.  Nothing switches from one to the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_layout(num_nodes, node_rank, local_ranks, local_rank):
    """(global rank, world size) of local rank `local_rank` of node
    `node_rank` with `local_ranks` processes on each of `num_nodes` nodes."""
    if num_nodes < 1 or local_ranks < 1:
        raise ValueError(f"{num_nodes} nodes of {local_ranks} ranks each")
    if not 0 <= node_rank < num_nodes:
        raise ValueError(f"node rank {node_rank} outside [0, {num_nodes})")
    if not 0 <= local_rank < local_ranks:
        raise ValueError(f"local rank {local_rank} outside [0, {local_ranks})")
    return node_rank * local_ranks + local_rank, num_nodes * local_ranks


def free_port():
    """A TCP port on localhost that is free now (for a one-node rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, *, device="cuda", backend=None,
                         timeout=DEFAULT_TIMEOUT):
    """Join the world group of `num_processes` ranks as rank `process_id`,
    with a TCP store at `coordinator_address` ("host:port", served by rank
    0), and return the group.  A no-op returning None for a single process,
    as in JAX.  The backend is `backend`, else `backend_for(device)` (gloo
    also moves CUDA tensors, e.g. for several ranks on one card, which NCCL
    refuses); a card with an index becomes this process's current device."""
    if num_processes is None or int(num_processes) <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several ranks needs the coordinator's "
                         "host:port and this process's rank")
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)
    return dist.group.WORLD


def spawn_ranks(fn, nprocs, *args):
    """`fn(local_rank, *args)` in `nprocs` new processes, waiting for all of
    them.  When one raises, the others are ended and its error is raised
    here (`torch.multiprocessing.spawn`)."""
    torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs, join=True)


def process_info(group=None, device="cuda"):
    """(rank, world size, this rank's device) in `group` (default: the world
    group when one is initialized, else rank 0 of 1).  For a card without an
    index, the current card."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank, world = (0, 1) if group is None else (group.rank(), group.size())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return rank, world, device


def local_batch_slice(global_batch_size, rank=None, world_size=None):
    """[start, stop) of this rank's rows of the global batch (rank and world
    size default to `process_info`'s)."""
    if rank is None or world_size is None:
        rank, world_size, _ = process_info(device="cpu")
    if global_batch_size % world_size:
        raise ValueError(f"batch_size {global_batch_size} must divide over "
                         f"{world_size} devices")
    per = global_batch_size // world_size
    return rank * per, (rank + 1) * per


# --- collectives on a group ---------------------------------------------------

def all_reduce_sum_(tensor, group):
    """Sum `tensor` over the ranks of `group`, in place.  (Gloo has no
    average: means are this sum divided by the world size, on every
    backend.)"""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_reduce_max_(tensor, group):
    """Elementwise maximum of `tensor` over the ranks of `group`, in place."""
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=group)
    return tensor


def broadcast_(tensor, group):
    """`tensor` of the group's rank 0 into every rank's, in place."""
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    group.broadcast([tensor], opts).wait()
    return tensor


def barrier(group, device):
    """Wait until every rank of `group` arrives (a one-element sum on
    `device`, which every backend runs on its own devices)."""
    all_reduce_sum_(torch.zeros(1, device=device), group)
