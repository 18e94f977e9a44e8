"""The profiler reading on a made-up trace: the busy union, a range's
device time inside its device-side spans, kernels by name, idle gaps named
by the host operation running at their start."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from harness.trace import Trace


def ev(name, start, end, device=False, children=(), kernels=()):
    e = NS(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
           time_range=NS(start=start, end=end), cpu_children=list(children),
           cpu_parent=None, kernels=list(kernels))
    for c in e.cpu_children:
        c.cpu_parent = e
    return e


@pytest.fixture
def trace():
    # host: one unit (0-100 us) holding a `render` range (10-60) with one op
    launch = ev("aten::mul", 12, 20)
    render = ev("render", 10, 60, children=[launch])
    unit = ev("unit", 0, 100, children=[render, ev("cudaDeviceSynchronize", 70, 100)])
    device = [ev("mul_kernel", 20, 30, True), ev("decode_composite_bf16", 30, 50, True),
              ev("other_kernel", 80, 90, True), ev("render", 20, 50, True),
              ev("mul_kernel", 85, 88, True)]   # overlaps other_kernel
    events = [unit, render, launch, unit.cpu_children[1]] + device
    return Trace(events, 100e-6, 1)


def test_busy_is_the_union_without_the_ranges_device_copies(trace):
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.busy_s == pytest.approx((30 + 10) * 1e-6)


def test_range_device_time_holds_the_ctypes_kernel(trace):
    assert trace.range_device_s("render") == pytest.approx(30e-6)
    assert trace.kernel_s("decode_composite") == pytest.approx(20e-6)
    assert trace.range_host_s("render") == pytest.approx(50e-6)
    assert trace.range_count("render") == 1


def test_idle_gaps_by_host_operation(trace):
    gaps = dict(trace.idle_gaps())
    # gaps 0-20 (the host in `unit`), 50-80 (in `render`), 90-100 (in the sync)
    assert gaps["unit"] == pytest.approx(20e-6)
    assert gaps["render"] == pytest.approx(30e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(trace.window_s - trace.busy_s)
    top = trace.top_device_ops()
    assert top[0][0] == "decode_composite_bf16" and len(top) == 3
