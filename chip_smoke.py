#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pix2pix3d_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its name and wall time:

1. device   -- CUDA card present; its name and `nvidia-smi` name/power limit.
2. build    -- nvcc builds `csrc/decode_composite.cu` for sm_90a.
3. kernel   -- the decode+composite kernel against its plain PyTorch
               version at the main-path shape (N=1, T=64 in chunks of 8,
               R=128^2) on seeded random inputs: f32 (TF32 off) and bf16,
               carry_f32 x sem_sigmoid; max and RMS errors, median times.
4. serve    -- full-width seg2cat serving forward (random weights from
               `torch.Generator().manual_seed(0)`): one warm-up, then 3
               requests at batch 1 with the kernel's launch count reset to
               0 just before and read just after (it must read 3); shapes,
               finiteness, per-request median ms, peak memory.
5. profile  -- one more request under `torch.profiler`: device busy time,
               idle share, each stage's time (the generator's
               `record_function` ranges) and the top kernels; the kernel's
               inputs on this request are kept for phase 7.
6. unfused  -- the same request's synthesis through the unfused frustum
               decode and composite against the kernel, all f32 with TF32
               off (one set of ws for both).
7. main-path kernel -- the kernel on the inputs the main path gave it:
               error against the plain version, times, bound, library
               yardstick.

The second-to-last line is the `kernels` JSON, the last line
`{"ok": true, "device": {...}}`.  Any failure raises: no phase catches its
own failure, and nothing runs on the CPU in place of the card.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# main-path shape of the decode+composite kernel (seg2cat serving)
NRR = 128
T_STEPS = 64
CHUNK = 8
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# special-function unit results (ex2, lg2, rcp) per clock per SM, compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table)
SFU_PER_CLOCK_SM = 16
# (per-element tolerance as allclose's rtol = atol, RMS tolerance or None).
# Kernel and plain version round h (and, without carry_f32, the colors) to
# bf16 in the same places and differ only where another summation order
# flips one rounding: a version that skips one of those casts differs on
# every element by 1e-5..2e-4 RMS at these inputs (sem_sigmoid x carry_f32,
# measured on the CPU), which the RMS gate fails; reorderings alone stay
# near 1e-6 RMS.
TOL = {torch.float32: (1e-4, None), torch.bfloat16: (1e-3, 5e-6)}

_T0 = time.time()


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')} +{time.time() - _T0:7.1f}s] {msg}",
          flush=True)


def phase_done(name, t0):
    log(f"phase {name}: {time.time() - t0:.2f} s")


def cuda_ms(fn, reps, warmup=2):
    """Median ms of `fn()` over `reps` runs, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(got, want, tol, rms_tol=None):
    """(max_abs, max_rel, used, rms) over a tuple of tensors: max_rel is
    max_abs over the largest |want|, `used` the largest share of the
    allclose(rtol=atol=tol) bound that any element takes, rms the
    root-mean-square error over all elements.  Raises if `used` passes 1 or
    rms passes `rms_tol`."""
    max_abs = used = scale = sq_err = 0.0
    count = 0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g).all() or not torch.isfinite(w).all():
            raise AssertionError("non-finite values")
        err = (g - w).abs()
        max_abs = max(max_abs, err.max().item())
        scale = max(scale, w.abs().max().item())
        used = max(used, (err / (tol + tol * w.abs())).max().item())
        sq_err += err.double().pow(2).sum().item()
        count += err.numel()
    rms = math.sqrt(sq_err / count)
    if used > 1.0:
        raise AssertionError(f"mismatch: max abs {max_abs:.3e}, {used:.2f}x the "
                             f"allclose bound at rtol=atol={tol}")
    if rms_tol is not None and rms > rms_tol:
        raise AssertionError(f"mismatch: RMS error {rms:.3e} > {rms_tol}")
    return max_abs, max_abs / max(scale, 1e-30), used, rms


def kernel_inputs(dc, dtype, sem_sigmoid, gen, device):
    """Seeded random inputs at the main-path shape; the weights are a
    lateSeparate decoder's, packed as the renderer packs them."""
    from pix2pix3d_tpu_torch.models.triplane import (
        OSGDecoderSemanticLateSeparate, init_parameters)
    dec = OSGDecoderSemanticLateSeparate(
        32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
             "sigmoid": sem_sigmoid})
    init_parameters(dec, gen)
    w1t, b1, w2t, b2 = (a.to(device) for a in
                        dc.fuse_late_separate_params_t(dec, 1.0))
    R = NRR * NRR
    feats = torch.randn((T_STEPS // CHUNK, 1, CHUNK, 32, R), generator=gen)
    t_vals = 2.0 + torch.sort(torch.rand((1, T_STEPS), generator=gen), dim=1)[0]
    dnorm = 1.0 + 0.1 * torch.rand((1, R), generator=gen)
    return (feats.to(device, dtype), t_vals.to(device), dnorm.to(device),
            w1t, b1, w2t, b2)


def bound(args, sem_sigmoid, sfu_per_s):
    """Least time (ms) for the kernel's work on these inputs, the largest of
    three terms: each input read once and each output written once over HBM
    bandwidth; the products the function needs (the nonzero weights of W1t
    and of the 65 W2t rows the composite reads) over the peak of the feats
    type; the transcendentals it needs over the special-function units'
    rate `sfu_per_s`.  Per sample: exp + log for each of the 128 softplus
    hidden units, exp + reciprocal for each clamped color (32 rgb, plus 32
    semantic if `sem_sigmoid`); per composite step (all slabs but the
    first): exp + log for the midpoint softplus and one exp for alpha.
    Returns (ms, bound_by, terms)."""
    feats, t_vals, dnorm, w1t, b1, w2t, b2 = args
    CH, N, TC, C, R = feats.shape
    T = CH * TC
    n_bytes = sum(a.numel() * a.element_size() for a in args) + N * 66 * R * 4
    macs = int((w1t != 0).sum().item()) + int((w2t[:65] != 0).sum().item())
    flops = 2 * T * N * R * macs
    sfu = N * R * (T * (2 * 128 + 2 * (64 if sem_sigmoid else 32)) + (T - 1) * 3)
    terms = {"bytes": (n_bytes, n_bytes / PEAK_BYTES_S * 1e3),
             "flops": (flops, flops / PEAK_FLOPS[feats.dtype] * 1e3),
             "transcendentals": (sfu, sfu / sfu_per_s * 1e3)}
    by = max(terms, key=lambda k: terms[k][1])
    return terms[by][1], ("bytes" if by == "bytes" else "operations"), terms


def library_ms(args, reps):
    """Yardstick: the decoder's two products for all T*R samples as
    torch.matmul calls (cuBLAS), without activations or the composite."""
    feats, t_vals, dnorm, w1t, b1, w2t, b2 = args
    CH, N, TC, C, R = feats.shape
    x = feats.permute(3, 0, 1, 2, 4).reshape(C, -1)
    w1 = w1t.to(feats.dtype)
    w2 = w2t.to(feats.dtype)
    return cuda_ms(lambda: torch.matmul(w2, torch.matmul(w1, x)), reps)


def main():
    # ---- 1. device
    t0 = time.time()
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a card")
        return 1
    sys.path.insert(0, ROOT)
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.models.triplane import STAGES
    from pix2pix3d_tpu_torch.ops import decode_composite as dc
    from pix2pix3d_tpu_torch.ops import precision
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler,
                                                   fov_to_intrinsics,
                                                   pose_to_conditioning)

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    def smi(query, *fmt):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]

    sm_clock_mhz = float(smi("clocks.max.sm", ",nounits"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_CLOCK_SM * n_sm * sm_clock_mhz * 1e6
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}; {n_sm} SMs, max SM clock "
        f"{sm_clock_mhz:.0f} MHz")
    print(smi("name,power.limit"), flush=True)
    phase_done("device", t0)

    # ---- 2. build
    t0 = time.time()
    so = dc.build(log=lambda out: print(out.strip(), flush=True))
    log(f"built {os.path.relpath(so, ROOT)}")
    phase_done("build", t0)

    # ---- 3. kernel vs plain on seeded random inputs
    t0 = time.time()
    gen = torch.Generator().manual_seed(1)
    with precision.policy(False):
        for dtype in (torch.float32, torch.bfloat16):
            tol, rms_tol = TOL[dtype]
            for carry_f32 in (True, False):
                for sem_sigmoid in (False, True):
                    args = kernel_inputs(dc, dtype, sem_sigmoid, gen, device)
                    kw = dict(sem_sigmoid=sem_sigmoid, carry_f32=carry_f32)
                    got = dc.fused_decode_composite(*args, **kw)
                    torch.cuda.synchronize()
                    want = dc.decode_composite_plain(*args, **kw)
                    abs_e, rel_e, used, rms = compare(got, want, tol, rms_tol)
                    k_ms = cuda_ms(lambda: dc.fused_decode_composite(*args, **kw), 5)
                    p_ms = cuda_ms(lambda: dc.decode_composite_plain(*args, **kw), 3)
                    log(f"kernel vs plain {str(dtype)[6:]:8s} carry_f32={carry_f32!s:5s} "
                        f"sem_sigmoid={sem_sigmoid!s:5s}: max abs {abs_e:.3e} rel {rel_e:.3e} "
                        f"({used:.3f} of tol {tol}), RMS {rms:.3e} (tol {rms_tol}); "
                        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    phase_done("kernel", t0)

    # ---- 4. serving forward, full width
    t0 = time.time()
    cfg = config.serving_generator_config("seg2cat")
    G = build_generator(device=device, seed=0, **cfg)
    res = cfg["img_resolution"]
    rng = torch.Generator().manual_seed(0)
    z = torch.randn((1, G.z_dim), generator=rng).to(device)
    mask = torch.randint(0, G.semantic_channels, (1, res, res, 1),
                         generator=rng).float().to(device)
    # the camera of __graft_entry__._example_inputs
    c2w = LookAtPoseSampler.sample(math.pi / 2, math.pi / 2, [0, 0, -0.06],
                                   radius=2.7, device=device)
    pose = pose_to_conditioning(c2w, fov_to_intrinsics(18.837, device=device))
    batch = {"mask": mask, "pose": pose}
    nrr = config.SERVING_NEURAL_RENDERING_RESOLUTION
    log(f"built seg2cat generator ({sum(p.numel() for p in G.parameters()) / 1e6:.1f} M "
        f"params) in {time.time() - t0:.1f} s")

    def request():
        with torch.no_grad(), precision.policy(True):
            return G(z, pose, batch, neural_rendering_resolution=nrr,
                     noise_mode="const")

    request()  # warm-up (cuDNN autotuning, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel = dc.fused_decode_composite
    kernel.launches = 0
    times, outs = [], None
    for i in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs = request()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if kernel.launches != i + 1:
            raise AssertionError(f"request {i + 1}: kernel launch count "
                                 f"{kernel.launches}, expected {i + 1}")
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 3:
        raise AssertionError(f"decode_composite launched {launches} times in 3 "
                             "requests, expected 3")
    expect = {"image": (1, res, res, 3), "image_raw": (1, nrr, nrr, 3),
              "image_depth": (1, nrr, nrr, 1),
              "semantic": (1, res, res, G.semantic_channels),
              "semantic_raw": (1, nrr, nrr, G.semantic_channels)}
    for key, shape in expect.items():
        if tuple(outs[key].shape) != shape:
            raise AssertionError(f"{key} {tuple(outs[key].shape)} != {shape}")
        if not torch.isfinite(outs[key]).all():
            raise AssertionError(f"{key} has non-finite values")
    request_ms = statistics.median(times)
    log(f"serve: 3 requests, kernel launches {launches}; per-request ms "
        f"{[round(t, 3) for t in times]} median {request_ms:.3f}; peak memory "
        f"{peak / 2**20:.1f} MiB")
    phase_done("serve", t0)

    # ---- 5. one request under the profiler; keeps the kernel's inputs
    t0 = time.time()
    captured = []

    def recording(*a, **kw):
        captured.append((a, kw))
        return kernel(*a, **kw)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    dc.fused_decode_composite = recording
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
    finally:
        dc.fused_decode_composite = kernel
    if len(captured) != 1:
        raise AssertionError(f"the request called the kernel wrapper "
                             f"{len(captured)} times, expected 1")
    events = prof.key_averages()
    # device entries (kernels, copies) outside the stage ranges' own device
    # spans; a CPU op's device time repeats its kernels', so it is left out
    device_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in STAGES]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3
    if busy_ms == 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"profile: request wall {wall_ms:.3f} ms under the profiler; device "
        f"busy {busy_ms:.3f} ms; idle share {1 - busy_ms / wall_ms:.3f}")
    ranges = {e.key: e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.key in STAGES}
    if set(ranges) != set(STAGES):
        raise AssertionError(f"stage ranges {sorted(ranges)} != {sorted(STAGES)}")
    for name in STAGES:
        log(f"stage {name:12s}: host {ranges[name].cpu_time_total / 1e3:9.3f} ms, "
            f"device kernels {ranges[name].device_time_total / 1e3:9.3f} ms")
    for e in sorted(device_ops, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    phase_done("profile", t0)

    # ---- 6. unfused decode/composite vs the kernel, f32 render, TF32 off
    t0 = time.time()
    rk = G.rendering_kwargs
    serving = dict(rk)
    # f32 everywhere: f32 render, f32 blocks, and no TF32 scope for the
    # semantic SR stack (its serving level "default" turns TF32 on)
    rk.update(frustum_bf16=False, sr_sem_precision=None)
    out_f32 = {}
    with torch.no_grad(), precision.policy(False):
        ws = G.mapping(z, pose, batch)
        for impl in ("kernel", None):
            rk["decoder_impl"] = impl
            out_f32[impl] = G.synthesis(ws, pose, neural_rendering_resolution=nrr,
                                        noise_mode="const", force_fp32=True)
    rk.clear()
    rk.update(serving)
    # the JAX suite's fused-vs-unfused generator tolerance
    # (tests/test_render_pallas.py::test_generator_fused_frustum_path)
    for key in expect:
        abs_e, rel_e, used, _ = compare((out_f32["kernel"][key],),
                                        (out_f32[None][key],), 5e-3)
        log(f"unfused vs kernel (f32) {key:12s}: max abs {abs_e:.3e} rel "
            f"{rel_e:.3e} ({used:.3f} of tol 5e-3)")
    for key in ("image_raw", "semantic_raw", "image_depth"):
        err = (outs[key].float() - out_f32["kernel"][key]).abs().max().item()
        log(f"serving (bf16) vs f32 render {key:12s}: max abs {err:.3e} (not gated)")
    phase_done("unfused", t0)

    # ---- 7. the kernel on the main path's own inputs
    t0 = time.time()
    a, kw = captured[0]
    args = tuple(a)
    tol, rms_tol = TOL[args[0].dtype]
    with precision.policy(False):
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = dc.decode_composite_plain(*args, **kw)
        max_abs, max_rel, used, rms = compare(got, want, tol, rms_tol)
        k_ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        p_ms = cuda_ms(lambda: dc.decode_composite_plain(*args, **kw), 5)
        lib_ms = library_ms(args, 10)
    b_ms, b_by, terms = bound(args, kw["sem_sigmoid"], sfu_per_s)
    log(f"main-path kernel inputs: feats {tuple(args[0].shape)} {args[0].dtype}, "
        f"{kw}; bound terms: " + ", ".join(
            f"{k} {n:.4g} -> {ms:.4f} ms" for k, (n, ms) in terms.items()))
    log(f"main-path kernel: max abs {max_abs:.3e} rel {max_rel:.3e} ({used:.3f} "
        f"of tol {tol}), RMS {rms:.3e} (tol {rms_tol}); "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    phase_done("main-path kernel", t0)

    print(json.dumps({"kernels": [{
        "name": "decode_composite", "route": "cuda",
        "source": "pix2pix3d_tpu_torch/csrc/decode_composite.cu",
        "replaces": "pix2pix3d_tpu/ops/render_pallas.py:231",
        "launches": launches, "max_abs_err": max_abs, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
