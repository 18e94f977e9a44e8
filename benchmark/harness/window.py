"""The measured window: whole units of work back to back (a closed loop),
timed on the host's clock.

A unit is whatever the traffic mix calls one (a batch of images, one
request, a training step) and ends with the device synchronized.  The window
opens at the first unit's start and ends with the last unit that began
before `seconds` had passed; rates are all its work over all its time, and
the latency tail is over all its units.
"""

from __future__ import annotations

import time

import numpy as np


class Window:
    def __init__(self, starts, ends):
        self.starts = np.asarray(starts, dtype=np.float64)
        self.ends = np.asarray(ends, dtype=np.float64)

    @property
    def units(self):
        return len(self.starts)

    @property
    def opened(self):
        return float(self.starts[0])

    @property
    def seconds(self):
        """From the first unit's start to the last unit's end."""
        return float(self.ends[-1] - self.starts[0])

    def latencies_s(self):
        return self.ends - self.starts

    def rate(self, work_per_unit):
        """All the work of the window over all of its time."""
        return self.units * work_per_unit / self.seconds

    def percentile_ms(self, q):
        """The q-th percentile (linear interpolation) of every unit's latency."""
        return float(np.percentile(self.latencies_s(), q) * 1e3)


def run(unit, seconds, clock=time.perf_counter, on_unit=None):
    """Call `unit(k)` for k = 0, 1, ... while `seconds` have not passed since
    the first call began; `on_unit(k, result)` sees each unit's result."""
    starts, ends = [], []
    t0 = None
    k = 0
    while True:
        start = clock()
        if t0 is None:
            t0 = start
        elif start - t0 >= seconds:
            break
        result = unit(k)
        ends.append(clock())
        starts.append(start)
        if on_unit is not None:
            on_unit(k, result)
        k += 1
    return Window(starts, ends)
