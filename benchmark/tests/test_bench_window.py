"""The window's statistics are over all its units: a stall in one unit
moves the rate and the tail; the window ends with the last unit that began
inside it."""

import numpy as np
import pytest

from harness import window


class FakeClock:
    """A clock that units advance: unit k takes `durations[k]` seconds."""

    def __init__(self, durations):
        self.t = 100.0
        self.durations = durations

    def __call__(self):
        return self.t

    def unit(self, k):
        self.t += self.durations[k]


def run(durations, seconds):
    clock = FakeClock(durations)
    return window.run(clock.unit, seconds, clock=clock)


def test_window_ends_with_the_last_unit_that_began_inside_it():
    w = run([0.4] * 10, 1.0)
    assert w.units == 3                 # starts at 0, 0.4, 0.8; 1.2 is outside
    assert w.seconds == pytest.approx(1.2)
    assert w.rate(32) == pytest.approx(3 * 32 / 1.2)


def test_a_stall_moves_the_rate():
    steady = run([0.1] * 400, 20.0)
    stalled = run([0.1] * 10 + [2.0] + [0.1] * 400, 20.0)
    assert stalled.rate(1) < steady.rate(1) * 0.92


def test_the_tail_is_over_all_requests():
    durations = [0.05] * 1000
    for k in range(0, 1000, 10):        # every tenth request is slow
        durations[k] = 0.5
    w = run(durations, 10.0)
    lat = w.latencies_s()
    assert len(lat) == w.units
    assert w.percentile_ms(95) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert w.percentile_ms(95) == pytest.approx(500.0)
    assert run([0.05] * 1000, 10.0).percentile_ms(95) == pytest.approx(50.0)


def test_results_reach_the_callback():
    seen = []
    clock = FakeClock([0.5] * 5)
    window.run(lambda k: clock.unit(k) or k * 10, 1.0, clock=clock,
               on_unit=lambda k, r: seen.append((k, r)))
    assert seen == [(0, 0), (1, 10)]
