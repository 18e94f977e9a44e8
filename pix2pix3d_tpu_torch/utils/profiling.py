"""Tracing and profiling helpers, port of `pix2pix3d_tpu/utils/profiling.py`.

The reference's `torch.autograd.profiler.record_function` regions and
CUDA-event phase timers (`misc.py:102-107`, `training_loop.py:375-379`):
`annotate` and `profiled_function` open `torch.profiler.record_function`
ranges, which a `trace(logdir)` capture (or any `torch.profiler.profile`)
records; `PhaseTimer` sums host wall time per phase name, synchronizing the
card first where asked.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.profiler import ProfilerActivity, record_function


def annotate(name):
    """A named profiler range (near-free when nothing is tracing)."""
    return record_function(name)


def profiled_function(fn):
    """Decorator version (ref `misc.profiled_function`, `misc.py:102-107`)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(getattr(fn, "__name__", "fn")):
            return fn(*args, **kwargs)
    return wrapper


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
