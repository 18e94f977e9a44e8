"""Arithmetic the metric readers share.  Each returns None where the run
has nothing to read (an untraced run, a range or kernel the path does not
have)."""

from __future__ import annotations

from . import counters

DECODE_KERNEL = "decode_composite"


def per_unit_ms(ctx, seconds):
    return seconds / ctx.trace.units * 1e3


def range_device_ms(ctx, *names):
    """Device time of the named ranges per traced unit (ms)."""
    if ctx.trace is None or not any(ctx.trace.range_spans(n) for n in names):
        return None
    return per_unit_ms(ctx, sum(ctx.trace.range_device_s(n) for n in names))


def range_host_ms(ctx, *names):
    """Host time of the named ranges per traced unit (ms)."""
    if ctx.trace is None or not any(ctx.trace.range_count(n) for n in names):
        return None
    return per_unit_ms(ctx, sum(ctx.trace.range_host_s(n) for n in names))


def idle_pct(ctx):
    """Share of the traced window in which no device operation ran (%)."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu_pct(ctx):
    """The reference's operations for the window's units over the window's
    time, as a share of the traffic's peak (%)."""
    if ctx.flops_per_unit is None:
        return None
    w = ctx.window
    return 100.0 * ctx.flops_per_unit * w.units / w.seconds / ctx.peak_flops


def decode_composite_roofline_pct(ctx):
    """Least time of the kernel's work (harness/counters.py) over its
    device time, per unit (%)."""
    if ctx.trace is None:
        return None
    kernel_s = ctx.trace.kernel_s(DECODE_KERNEL)
    if kernel_s <= 0:
        return None
    rk = ctx.gkw["rendering_kwargs"]
    nrr = ctx.nrr
    n_bytes, flops = counters.decode_composite_work(
        ctx.traffic["batch"], rk["frustum_depth_steps"], nrr * nrr,
        2 if rk.get("frustum_bf16", True) else 4)
    bound = counters.bound_s(n_bytes, flops, counters.PEAK_FLOPS["bf16"])
    return 100.0 * bound * ctx.trace.units / kernel_s
