"""Tracing and profiling helpers, port of `pix2pix3d_tpu/utils/profiling.py`.

The reference's `torch.autograd.profiler.record_function` regions and
CUDA-event phase timers (`misc.py:102-107`, `training_loop.py:375-379`):
`annotate` is the port's one span: a `torch.profiler.record_function`
range while a profiler collects (a `trace(logdir)` capture or any
`torch.profiler.profile`), else a shared no-op, so an untraced run pays a
flag check, not a range.  `host_read` is the one counted device-to-host
read: each call is a `sync.<reason>` span, whose count is the number of
host syncs and whose length is the host's wait on the device.
`PhaseTimer` sums host wall time per phase name, synchronizing the card
first where asked.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, record_function

_NO_SPAN = contextlib.nullcontext()


def annotate(name):
    """A named profiler range while a profiler collects, else a no-op.

    The flag is read at each call, so a profiler started after import sees
    every span; a `record_function` range costs over 10 us of host time even
    with no profiler running, the flag check well under 1 us."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def host_read(tensor, reason):
    """`tensor.tolist()` inside a `sync.<reason>` span: the path's
    deliberate device-to-host reads, counted and timed by the profiler."""
    with annotate(f"sync.{reason}"):
        return tensor.tolist()


@contextlib.contextmanager
def trace(logdir):
    """Capture the host's and, with a card, the device's activity while the
    block runs, written under `logdir` as a `*.pt.trace.json` (TensorBoard's
    profiler plugin or chrome://tracing reads it).  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(logdir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def _synchronize(block_on):
    """Wait for the card(s) that `block_on` (a tensor, a device or its name,
    or a list, tuple or dict of them) lives on."""
    if isinstance(block_on, dict):
        block_on = list(block_on.values())
    if isinstance(block_on, (list, tuple)):
        for item in block_on:
            _synchronize(item)
        return
    device = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Host-side wall time per phase name (the reference's CUDA-event
    analog): `with timer.tick(name, block_on=x):` around device work
    synchronizes the device of `x` before it stops the clock."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def tick(self, name, block_on=None):
        start = time.perf_counter()
        yield
        if block_on is not None:
            _synchronize(block_on)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - start
        self.counts[name] = self.counts.get(name, 0) + 1

    def means_ms(self):
        return {k: 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}
