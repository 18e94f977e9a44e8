"""Training statistics, port of `pix2pix3d_tpu/train/stats.py` (ref
`torch_utils/training_stats.py`).

Each phase reports `[count, sum, sum_sq]` moments per metric as tensors on
the card (`StatsAccumulator`); the trainer stacks a step's moments into one
tensor and brings it to the host once, where `Collector` aggregates them
across the steps of a tick.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def moments(value):
    """[count, sum, sum_sq] of a tensor (float32, detached), shape [3]."""
    v = value.detach().float()
    return torch.stack([torch.full((), float(v.numel()), device=v.device),
                        v.sum(), v.square().sum()])


class StatsAccumulator:
    """Collects name -> moments during one phase."""

    def __init__(self):
        self._stats = {}

    def report(self, name, value):
        m = moments(value)
        self._stats[name] = self._stats[name] + m if name in self._stats else m

    def asdict(self):
        return dict(self._stats)


class Collector:
    """Host-side running aggregation across steps (ref `Collector`, `:115-163`)."""

    def __init__(self):
        self._totals = collections.defaultdict(lambda: np.zeros(3, np.float64))

    def update(self, stats_dict):
        for k, v in stats_dict.items():
            self._totals[k] += np.asarray(v, np.float64)

    def mean(self, name):
        c, s, _ = self._totals.get(name, np.zeros(3))
        return float(s / c) if c > 0 else float("nan")

    def std(self, name):
        c, s, ss = self._totals.get(name, np.zeros(3))
        if c <= 0:
            return float("nan")
        m = s / c
        return float(np.sqrt(max(ss / c - m * m, 0)))

    def as_means(self):
        return {k: self.mean(k) for k in self._totals}

    def reset(self):
        self._totals.clear()
