"""On a card, at each cell's own sizes: the control (the plain reference one
precision below the configuration's, `harness.compare.control`) fails the
cell's limits, and the program passes them, on a seed the limits were not
set from.  Run on the card with `python -m pytest benchmark/tests -m cuda`."""

import math

import pytest

import calibrate
from harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 2024


def failed(values, limits):
    return [k for k, lim in limits.items() if not (math.isfinite(values[k]) and values[k] <= lim)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    cell = spec.cell(name)
    limits = cell["limits"]["numbers"]
    assert failed(calibrate.readings(cell, SEED, "control", card), limits)
    assert not failed(calibrate.readings(cell, SEED, "program", card), limits)
