"""The traced run's reading of the profiler (`torch.profiler`, CPU and CUDA
activities).

- Device busy time: the union of every device operation's interval
  (kernels, copies, sets), leaving out the device-side copies of the
  host's `record_function` ranges, which span kernels and are no work.
- A range's device time: the device busy time inside the range's
  device-side spans.  The profiler's device copy of a `record_function`
  range spans the work launched inside it, a kernel launched through
  `ctypes` too, which the profiler ties to no operator.  (Summing the
  kernels tied to the range's operators instead read 2.86-3.07 s for
  seg2cat's `render` where the spans held 2.11 s of busy time: the
  operators share kernels.)
- Idle gaps: the holes in the busy union inside the traced window, each
  named by the innermost host operation running at its start.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

UNIT_RANGE = "unit"


def record(unit, units, first=0):
    """Run units `first .. first+units-1` under the profiler, each in a
    `unit` range, and return their `Trace`."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(first, first + units):
            with record_function(UNIT_RANGE):
                unit(k)
        wall = time.perf_counter() - t0
    return Trace(prof.events(), wall, units)


def _is_device(e):
    return e.device_type == DeviceType.CUDA


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, events, wall_s, units):
        self.events = list(events)
        self.wall_s = wall_s
        self.units = units
        cpu = [e for e in self.events if not _is_device(e)]
        # a device event named as a host event is a range's device-side copy
        self.host_names = {e.name for e in cpu} | {UNIT_RANGE}
        self.device_ops = [e for e in self.events if _is_device(e)
                           and e.name not in self.host_names]
        self.cpu = cpu
        units_ev = [e for e in cpu if e.name == UNIT_RANGE]
        if units_ev:
            self.t0 = min(e.time_range.start for e in units_ev)
            self.t1 = max(e.time_range.end for e in units_ev)
        else:
            self.t0 = self.t1 = 0.0
        self.busy = _union([(e.time_range.start, e.time_range.end)
                            for e in self.device_ops])

    # ---------------------------------------------------------------- whole
    @property
    def window_s(self):
        """The traced window: from the first unit's start to the last one's
        end, on the profiler's clock."""
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return sum(min(e, self.t1) - max(s, self.t0) for s, e in self.busy
                   if e > self.t0 and s < self.t1) / 1e6

    # --------------------------------------------------------------- ranges
    def _ranges(self, name):
        return [e for e in self.cpu if e.name == name]

    def range_count(self, name):
        return len(self._ranges(name))

    def range_spans(self, name):
        """The device-side copies of the named range: each spans the device
        work of the operations launched inside it, ctypes launches too."""
        return _union([(e.time_range.start, e.time_range.end) for e in self.events
                       if _is_device(e) and e.name == name])

    def busy_within(self, spans):
        """Device busy seconds inside `spans` (sorted, disjoint)."""
        total, j = 0.0, 0
        for s, e in spans:
            while j < len(self.busy) and self.busy[j][1] <= s:
                j += 1
            k = j
            while k < len(self.busy) and self.busy[k][0] < e:
                total += min(e, self.busy[k][1]) - max(s, self.busy[k][0])
                k += 1
        return total / 1e6

    def range_device_s(self, name):
        """Device busy time inside the range's device-side spans."""
        return self.busy_within(self.range_spans(name))

    def range_host_s(self, name):
        return sum(e.time_range.end - e.time_range.start
                   for e in self._ranges(name)) / 1e6

    def kernel_s(self, kernel):
        """Device time of every operation whose name holds `kernel`."""
        return sum(e.time_range.end - e.time_range.start
                   for e in self.device_ops if kernel in e.name) / 1e6

    # ------------------------------------------------------------ breakdown
    def top_device_ops(self, n=10):
        by = defaultdict(float)
        for e in self.device_ops:
            by[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def _children(self, e):
        """(children sorted by start, their starts), computed once."""
        got = self._sorted.get(id(e))
        if got is None:
            kids = sorted(e.cpu_children, key=lambda c: c.time_range.start)
            got = self._sorted[id(e)] = (kids, [c.time_range.start for c in kids])
        return got

    def _host_at(self, t, level, level_starts):
        """Name of the innermost host operation running at time t."""
        name = "host outside any operation"
        while level:
            i = bisect.bisect_right(level_starts, t) - 1
            if i < 0 or level[i].time_range.end < t:
                break
            name = level[i].name
            level, level_starts = self._children(level[i])
        return name

    def idle_gaps(self, n=10):
        """The idle time of the traced window, summed by what the host was
        doing at each gap's start: [[host operation, seconds], ...]."""
        roots = sorted((e for e in self.cpu if e.cpu_parent is None),
                       key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in roots]
        gaps, prev = [], self.t0
        for s, e in self.busy:
            if e <= self.t0 or s >= self.t1:
                continue
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        self._sorted = {}
        by = defaultdict(float)
        for s, e in gaps:
            by[self._host_at(s, roots, starts)] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def breakdown(self):
        return {"device_ops": self.top_device_ops(), "idle_gaps": self.idle_gaps()}
