#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pix2pix3d_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its name and wall time:

1. device   -- CUDA card present; its name and `nvidia-smi` name/power limit.
2. build    -- nvcc builds both kernels for sm_90a from `csrc/`, one nvcc
               process each, started together: `decode_composite.cu` and
               `late_separate_decode.cu`; ptxas's registers and spills for
               each kernel function (each dtype instantiation).
3. kernel   -- the decode+composite kernel against its plain PyTorch
               version at the main-path shape (N=1, T=64 in chunks of 8,
               R=128^2) on seeded random inputs: f32 (TF32 off) and bf16,
               carry_f32 x sem_sigmoid; max and RMS errors, times.
               Every weight set fed to a kernel in this script is checked
               to be block-diagonal as `fuse_late_separate_params(_t)`
               packs it (the kernels read only the two live blocks).
4. serve    -- full-width seg2cat serving forward (random weights from
               `torch.Generator().manual_seed(0)`): one warm-up, then 3
               requests at batch 1, both kernels' launch counts reset to 0
               just before each and read just after it (decode_composite
               must add 1 a request, late_separate_decode 0); shapes,
               finiteness, per-request median ms, peak memory; then two
               requests with noise_mode="random" from equally seeded card
               generators must agree exactly, and differ from const noise
               once the noise strengths are set.
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
8. decoder kernel -- the lateSeparate decode kernel against its plain
               version on seeded random inputs, f32 and bf16 x rgb_sigmoid x
               sem_sigmoid, at the importance path's chunk (65,536 rows), at
               scripts/profile_decoder.py's working set (12,582,912 rows)
               and at an odd size (600 rows); max and RMS errors, median
               times; then, at 600 rows, a contiguous view one element into
               its storage (off the words the kernel reads rows in).
9. serve-importance -- the full-width seg2cat generator of the apps
               (`preset_generator_config("seg2cat")`, no `sampler`, so the
               two-pass importance renderer runs) at batch 1, nrr 128,
               det=True, f32 with TF32 off: one warm-up, 3 requests (both
               kernels' counts must stay 0: the generator decodes with
               impl="ref"), shapes, finiteness, median ms, peak memory; then
               one request under `torch.profiler`.
10. importance kernel -- the same planes and camera through `G.renderer`
               with `G.decoder(f, d, impl="kernel")` and with impl="ref",
               f32 with TF32 off: the counts, reset just before, must read
               24 (2 passes x 12 chunks of 65,536 points) for the decoder
               kernel and 0 for decode_composite; the
               two renders agree; then the kernel on one chunk's inputs as
               the path gave them: error against the plain version, times,
               bound, library yardstick.

11. checkpoint -- the apps' seg2cat generator of phase 9 through
               `bridge.params_to_jax`, written with the port's
               `save_checkpoint` into a temporary directory twice (f32, and a
               bf16 `G_ema` export as scripts/export_ema.py writes it), each
               with its config sidecar, each read back through
               `build_app_generator("seg2cat", checkpoint=...)`: every
               parameter equals the source bit for bit (f32) or the source
               rounded to bf16 (export); sizes, write and read times.
12. apps     -- on the generator read from the f32 file (importance
               sampler, 512²): `generate_sample` (one warm-up, 3 requests,
               median ms); `render_video` over 8 frames, the backbone run
               once (a forward hook counts it); `extract_semantic_mesh` at
               MESH_RESOLUTION (the sigma grid, marching cubes on it and the
               whole call timed, vertex and face counts; the threshold is
               the grid's 90th percentile, random weights having no surface
               at the app's 50); an `EditSession` (yaw 0, yaw 0.3 on the same ws, a
               brush edit, yaw 0 again).  Neither kernel may launch.
13. apps-serving -- the same generator with the port's
               `config.SERVING_RENDERING` keys on its `rendering_kwargs`
               (frustum sampler, fused decode+composite, 64 slabs in
               chunks of 8, f32 carry): `generate_sample` launches
               decode_composite once per request (3 requests, both counts
               reset just before and read after each); finite outputs.
14. released configs -- one `generate_sample` each of seg2face (512², 19
               classes) and edge2car (128², edge mapping, white_back, nrr
               64) at full width, random weights: shapes and finiteness.
15. train-parity -- one `Trainer.step` at step_idx 0 (cross-view renders,
               Gmain, Greg, Dmain + w_avg, Dreg, D_semantic main and reg,
               EMA) of the CPU tests' small configuration (128², cbase 512,
               cmax 16, 4+4 depth samples, nrr 16, batch 2, the recipe's
               loss settings), once on the card and once on the CPU, f32
               with TF32 off, equal weights and equal CPU generators: every
               stat within 1e-3 relative + 1e-5, each network's Adam mu/nu
               per leaf within 1e-2 (2e-2) of the leaf's largest, and at
               most 2% of each network's entries (G, D, D_semantic, G_ema)
               apart by more than 1e-5 after the step (the first Adam step,
               b1 = 0, moves an entry by lr times the sign of its gradient,
               which rounding flips where the gradient is noise).  Then R1
               through the recipe's bf16 discriminator blocks at that width
               (`check_r1_bf16`): the gradfix convolutions against
               `F.conv2d`'s own double backward (f32), and bf16 against f32,
               within R1_TOL.
16. train    -- the seg2cat training recipe at full width (512², random
               weights from seed 0, batch 4, no accumulation) through the
               CLI's `main` with the recipe's flags, as `python -m
               pix2pix3d_tpu_torch.train` runs it (its loop sets f32 with
               TF32 off; the fp16 blocks run bf16), on a synthetic folder of
               16 512² images and 6-class masks written with the port's PNG
               encoder: steps 0-3 (step 0 runs every phase), each timed
               alone, every stat finite, TF32 off inside the loop, w_avg
               moved, G_ema != G after step 1, stats.jsonl, the image grids
               and the snapshot written, neither kernel launched (the
               training path decodes with impl="ref").  Before step 2 the
               full training state goes through a checkpoint file into a
               fresh trainer (equal bit for bit) and into an in-memory copy;
               after the loop's step 2 both run step 2 from its inputs and
               generator state under PyTorch's deterministic algorithms and
               must agree bit for bit; the loop's own step 2 (default
               algorithms) against them is printed.  The fresh trainer then
               runs one step without the reg phases, then one more under
               the profiler (device activity only): the idle share.  (Each phase's device
               span comes from phase 17's profiled step: tracing the host
               costs ~45 s a step.)  Step 0 ms, steps 1-3
               and their median, images/s and peak memory come from the
               loop's own steps, none of them profiled.
17. train-aug -- ADA.  The pipe (train.py's set) at p=0 returns a
               [4, 512, 512, 6] batch bit for bit on the card; the pipe and
               one R1 phase (p=1) at phase 15's small width, card against
               CPU on the same draws.  The recipe of phase 16 with `--aug
               fixed --p 0.2` through the CLI for 4 steps, a snapshot at its
               tick (TensorBoard, the fd trend): step 0, steps 1-3 and
               their median, images/s, peak memory, and after step 3 one
               extra step with every phase on a copy of the trainer, then
               one more under the profiler (host and device activity: each
               phase's device span, the idle share).  Then `--aug ada --target=-1.5` for 8 steps in ticks
               of 4: the logged `Progress/augment_p` must equal
               `ada_update_p` folded over the logged `Loss/signs/real`, and
               move above 0.
18. sinks    -- phase 17's run directory: every record of its TensorBoard
               event file passes the length and data CRC-32C checks of a
               reader in this script (7 records: header, scalars, the
               trend, four grids); quality.jsonl holds a finite
               `fd_proxy_real_fake` (a skipped trend writes none).
19. train-frustum -- `--sampler frustum` (train.py's defaults: 96 slabs
               in chunks of 8, bf16 slabs): one G main phase, card against
               CPU at the small width with f32 slabs (without the
               cross-view term: one render); the recipe for 4 steps with
               the numbers of phase 17 but the phase spans (one more step
               without the reg phases under the profiler, device activity
               only: the idle share); after step 3 the G main phase at full
               width: every gradient entry finite (before the trainer's
               nan_to_num), its peak memory with `frustum_remat` on and off
               (off reported, also if it does not fit).
20. train-remat -- `--remat True` for 4 steps, beside phase 16's numbers;
               from the state after step 1, one copy with remat and one
               without run step 2 from its inputs and generator state under
               deterministic algorithms: equal bit for bit.
21. autograd guard -- each kernel wrapper, called on the card with an input
               that requires grad under grad mode, raises before it
               launches; under `torch.no_grad()` it runs.
Both kernels' launch counts stay 0 on every path of phases 17-21: the
training path decodes with impl="ref", as the JAX trainer does.

22. eg3d-cond -- conditional EG3D (`generator_config(cfg="afhq",
               resolution=512, render_mask=False, semantic_channels=6,
               gen_pose_cond=True)`: `TriPlaneGenerator`, OSGDecoder, one
               SR stack) at full width: one batch-1 request at nrr 128 on
               the importance sampler (f32, TF32 off) and one on the
               frustum sampler (the serving keys but the fused decoder,
               which it refuses with a ValueError, as the JAX package);
               then phase 16's recipe with train.py's defaults for
               --render_mask/--dis_mask (and its lambda_cross_view 0: the
               cross-view renders read semantic outputs) for 4 steps at
               batch 4, no snapshots, and one more step, device-only
               profiled: steps 1-3 median, peak, idle share.
23. seg2cat-bg -- the background generator (`use_bg=True`) under the
               serving keys: 2 requests (decode_composite once each), the
               `weight` image; the fused render against the unfused one
               (f32, FUSED_TOL); decode_composite against its plain version
               on the request's inputs; the importance render of the
               request's planes through `G.decoder(f, d, impl="kernel")`
               (24 launches) against impl="ref", and late_separate_decode
               against its plain version on its first chunk; one request on
               the importance sampler; then the recipe with `--use_bg True
               --silhouette_loss True` for 4 steps at batch 4 as phase 22.
24.-26. other generators -- one request each at full width (importance
               sampler, f32, TF32 off): seg2face at 256² (the 4X SR pair),
               the two-backbone `TriPlaneSemanticGenerator` at seg2cat
               width, seg2cat with the entangled `MaskMappingNetwork` and
               edge2car with `EdgeMappingNetwork`.
27. dual-sr  -- the serving generator without sr_sem_precision (which
               takes priority over dual_sr): synthesis from cached planes
               with `dual_sr` on and off, alternating, as served (bf16 SR
               blocks, TF32) and all f32 with TF32 off: f32 outputs within
               DUAL_TOL (tests/test_dual_sr.py's gate), bf16 ones within the
               bf16 blocks' own rounding against f32; each call's ms.
Every request of phases 22-27 prints its outputs' shapes (finite), its
time and the generator's parameter count; their paths join
`launches_by_path`.

28. metrics  -- the metrics package through the full-width serving
               generator (random weights, nrr 128) at batch 8 on phase 17's
               16 synthetic 512² images and masks (`train.dataset
               .build_dataset`): `metric_main.calc_metric("miou500")` in full
               (63 forwards: miou, pixel_acc, total_time, ms per image against
               8 batch-1 requests of phase 4, peak memory); FID, KID and PR on
               the random-convolution proxy and FID and IS on the port's
               Inception-v3 (random weights written to a temporary npz named
               by PIX2PIX3D_INCEPTION_NPZ) at METRIC_REAL real and METRIC_GEN
               generated images (the registered sizes, fid2k's 2000, do not
               fit this script's time); PPL on METRIC_PPL samples.  Each value
               with its seconds, split into generation and features by
               `utils.profiling.PhaseTimer`.  decode_composite must launch
               once per generator forward (and per PPL synthesis) on the
               `metrics` path, late_separate_decode never; one batch-8 call's
               inputs (N=8) against the plain version at phase 3's
               tolerances, with times and bound; the fused render against
               decoder_impl=None on one batch, as served: argmax semantic
               maps agree on at least ARGMAX_AGREE of pixels (measured
               0.99905 on an NVIDIA H100 80GB HBM3 at 700 W, where 0.011 of
               the pixels had their top two unfused logits within the
               renders' largest logit difference);
               that batch's forward under the profiler (idle share, stages).

Times: in the `kernels` line, `ms`, `plain_ms` and `library_ms` time one
call between CUDA events (`cuda_ms`), the host's launch path included;
`device_ms`, `plain_device_ms` and `library_device_ms` time the same calls
repeated in one CUDA graph (`device_ms`), so that the host's launch overhead
and the wrappers' casts are left out.

Each kernel in the `kernels` line also gives `launches_by_path`: its
launch count on each path, every path run through `PathCounts.run`, which
sets both kernels' counts to 0 just before each step of the path and reads
them just after (`launches` is the main path's: serve for
decode_composite, the importance kernel render for late_separate_decode).

Every number these phases print is measured on the card named in phase
device (name and power limit as `nvidia-smi` gives them).

The second-to-last line is the `kernels` JSON, the last line
`{"ok": true, "device": {...}}`.  Any failure raises: no phase catches its
own failure, and nothing runs on the CPU in place of the card.
"""

import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
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
# late_separate_decode against its plain version, (per-element tolerance,
# RMS tolerance of colors and of sigma, each, or None).  f32: the JAX
# suite's gate for this kernel (tests/test_decoder_pallas.py).  bf16: the
# outputs themselves are bf16, so another summation order may flip one bf16
# rounding (one ulp, <= 7.8e-3 below 2); on the CPU the JAX kernel reads
# RMS <= 4.9e-5 against the plain version, a version that skips the cast of
# h or of sigma RMS >= 1.7e-3 (tests/test_torch_late_separate.py).
DECODE_TOL = {torch.float32: (2e-5, None), torch.bfloat16: (8e-3, 2e-4)}
# rows of late_separate_decode's cases: the importance renderer's chunk,
# scripts/profile_decoder.py's working set (batch 8, 128^2 rays, 96
# samples), and an odd size
DECODE_ROWS = (65536, 8 * 128 * 128 * 96, 600)
# the apps' seg2cat neural rendering resolution
# (pix2pix3d_tpu/apps/common.py APP_PRESETS)
APP_NRR = 128
# the importance renderer's gate, kernel decoder against impl="ref" (the
# JAX suite's renderer parity tolerance, tests/test_parity_render.py)
RENDER_TOL = 1e-4
# phase apps: the mesh grid's resolution (the app's default) and frames
MESH_RESOLUTION = 256
VIDEO_FRAMES = 8
NO_LAUNCHES = {"decode_composite": 0, "late_separate_decode": 0}
ONE_DECODE_COMPOSITE = {"decode_composite": 1, "late_separate_decode": 0}

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


def device_ms(fn, reps):
    """Device time (ms) of one `fn()` without the host's launch overhead:
    `reps` calls captured in one CUDA graph, the graph replayed 3 times
    between CUDA events, the median over the replays divided by `reps`.
    `fn` must take its inputs as the kernel does (dtypes converted
    beforehand), so that only its own kernels run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    # cuBLAS keeps a workspace for every stream that ran a product (here the
    # side and capture streams); release them, so that later phases' peak
    # memory is what it would be without this timing
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
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


def ptxas_report(out, cufilt):
    """[(kernel function, registers, spill store bytes, spill load bytes)]
    from nvcc's `-Xptxas -v` output, the names demangled by `cufilt` (the
    toolkit's `cu++filt`) without their parameters."""
    rows, name, spills = [], None, (0, 0)
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    if rows:
        names = subprocess.run([cufilt, "-p"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        rows = [(n, *r[1:]) for n, r in zip(names, rows)]
    return rows


def check_block_diagonal(w2, transposed):
    """The packed W2 (`[hidden, out]`, or W2ᵀ if `transposed`) is zero
    outside its two live blocks, [0:64, 0:32] and [64:128, 32:65], the only
    entries the kernels read."""
    w = w2.t() if transposed else w2
    live = torch.zeros((128, 128), dtype=torch.bool, device=w.device)
    live[:64, :32] = True
    live[64:, 32:65] = True
    if tuple(w.shape) != (128, 128) or (w[~live] != 0).any():
        raise AssertionError("W2 is not the block-diagonal packing of "
                             "fuse_late_separate_params")


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
    check_block_diagonal(w2t, transposed=True)
    R = NRR * NRR
    feats = torch.randn((T_STEPS // CHUNK, 1, CHUNK, 32, R), generator=gen)
    t_vals = 2.0 + torch.sort(torch.rand((1, T_STEPS), generator=gen), dim=1)[0]
    dnorm = 1.0 + 0.1 * torch.rand((1, R), generator=gen)
    return (feats.to(device, dtype), t_vals.to(device), dnorm.to(device),
            w1t, b1, w2t, b2)


def kernel_typed(args):
    """decode_composite's inputs with the weights already in the feats
    type, as the wrapper casts them, so that timing sees only the kernel."""
    feats, t_vals, dnorm, w1t, b1, w2t, b2 = args
    return feats, t_vals, dnorm, w1t.to(feats.dtype), b1, w2t.to(feats.dtype), b2


def decode_typed(args, dtype):
    """late_separate_decode's inputs in the compute type, as the wrapper
    casts them."""
    feats, w1, b1, w2, b2 = args
    return feats.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2


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
    return _largest(n_bytes, flops, PEAK_FLOPS[feats.dtype], sfu, sfu_per_s)


def _largest(n_bytes, flops, peak_flops, sfu, sfu_per_s):
    terms = {"bytes": (n_bytes, n_bytes / PEAK_BYTES_S * 1e3),
             "flops": (flops, flops / peak_flops * 1e3),
             "transcendentals": (sfu, sfu / sfu_per_s * 1e3)}
    by = max(terms, key=lambda k: terms[k][1])
    return terms[by][1], ("bytes" if by == "bytes" else "operations"), terms


def achieved(terms, ms, sm_clock_hz, n_sm):
    """What the kernel reached in `ms` on each bound term: bytes/s and
    FLOP/s as shares of their peaks, special-function results per clock per
    SM (the table's rate is SFU_PER_CLOCK_SM)."""
    (nb, b_ms), (nf, f_ms), (nt, _) = (terms[k] for k in
                                       ("bytes", "flops", "transcendentals"))
    per_clk_sm = nt / (ms * 1e-3) / sm_clock_hz / n_sm
    return (f"achieved: {b_ms / ms:.3f} of the memory rate, {f_ms / ms:.3f} of "
            f"the product rate, {per_clk_sm:.2f} special-function results per "
            f"clock per SM (table {SFU_PER_CLOCK_SM})")


def bound_decode(args, kw, sfu_per_s):
    """Least time (ms) for late_separate_decode's work on these inputs, the
    largest of three terms: each input read once (feats as given, weights)
    and each output written once (colors in the compute type, sigma f32)
    over HBM bandwidth; the nonzero multiply-adds (W1, and W2's 65 live
    columns) over the compute type's peak; per row exp + log for each of
    the 128 softplus units and exp + reciprocal for each clamped color over
    the special-function units' rate.  Returns (ms, bound_by, terms)."""
    feats, w1, b1, w2, b2 = args
    cd = kw["compute_dtype"]
    m = feats.shape[0]
    n_bytes = sum(a.numel() * a.element_size() for a in args) \
        + m * 64 * torch.empty((), dtype=cd).element_size() + m * 4
    macs = int((w1 != 0).sum().item()) + int((w2[:, :65] != 0).sum().item())
    n_clamped = 32 * bool(kw["rgb_sigmoid"]) + 32 * bool(kw["sem_sigmoid"])
    sfu = m * (2 * 128 + 2 * n_clamped)
    return _largest(n_bytes, 2 * m * macs, PEAK_FLOPS[cd], sfu, sfu_per_s)


def decode_inputs(rows, dtype, sem_sigmoid, seed, device):
    """Seeded random features [rows, 32] in `dtype` (drawn on the card) and
    the packed weights of a lateSeparate decoder with random init."""
    from pix2pix3d_tpu_torch.models.triplane import (
        OSGDecoderSemanticLateSeparate, init_parameters)
    from pix2pix3d_tpu_torch.ops.decode_composite import fuse_late_separate_params
    dec = OSGDecoderSemanticLateSeparate(
        32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
             "sigmoid": sem_sigmoid})
    init_parameters(dec, torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((rows, 32), generator=gen, device=device).to(dtype)
    w1, b1, w2, b2 = (a.to(device) for a in fuse_late_separate_params(dec, 1.0))
    check_block_diagonal(w2, transposed=False)
    return feats, w1, b1, w2, b2


def compare_decode(got, want, dtype):
    """compare() for (colors, sigma) at DECODE_TOL, each output on its own;
    returns (max abs, largest share of the tolerance, RMS colors, RMS
    sigma)."""
    tol, rms_tol = DECODE_TOL[dtype]
    a_c, _, u_c, r_c = compare((got[0],), (want[0],), tol, rms_tol)
    a_s, _, u_s, r_s = compare((got[1],), (want[1],), tol, rms_tol)
    return max(a_c, a_s), max(u_c, u_s), r_c, r_s


def decode_library_ms(args, cd, reps):
    """Yardstick: the decoder's two products as torch.matmul calls
    (cuBLAS), without activations: [M,32]x[32,128] then [M,128]x[128,128];
    (call ms, device ms)."""
    x, w1, _, w2, _ = args
    x, w1, w2 = x.to(cd), w1.to(cd), w2.to(cd)

    def fn():
        return torch.matmul(torch.matmul(x, w1), w2)
    return cuda_ms(fn, reps), device_ms(fn, reps)


def profile_request(request, stages):
    """One request under torch.profiler: logs the wall and device busy
    time, the idle share, each stage range's host and device time and the
    top kernels; returns (wall ms, busy ms, {stage: device ms})."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    # device entries (kernels, copies) outside the stage ranges' own device
    # spans; a CPU op's device time repeats its kernels', so it is left out
    device_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in stages]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3
    if busy_ms == 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"profile: request wall {wall_ms:.3f} ms under the profiler; device "
        f"busy {busy_ms:.3f} ms; idle share {1 - busy_ms / wall_ms:.3f}")
    ranges = {e.key: e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.key in stages}
    if set(ranges) != set(stages):
        raise AssertionError(f"stage ranges {sorted(ranges)} != {sorted(stages)}")
    for name in stages:
        log(f"stage {name:12s}: host {ranges[name].cpu_time_total / 1e3:9.3f} ms, "
            f"device kernels {ranges[name].device_time_total / 1e3:9.3f} ms")
    for e in sorted(device_ops, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    return wall_ms, busy_ms, {k: ranges[k].device_time_total / 1e3 for k in stages}


def check_outputs(outs, res, nrr, semantic_channels):
    """The five outputs have their shapes and are finite."""
    expect = {"image": (1, res, res, 3), "image_raw": (1, nrr, nrr, 3),
              "image_depth": (1, nrr, nrr, 1),
              "semantic": (1, res, res, semantic_channels),
              "semantic_raw": (1, nrr, nrr, semantic_channels)}
    for key, shape in expect.items():
        if tuple(outs[key].shape) != shape:
            raise AssertionError(f"{key} {tuple(outs[key].shape)} != {shape}")
        if not torch.isfinite(outs[key]).all():
            raise AssertionError(f"{key} has non-finite values")
    return expect


def library_ms(args, reps):
    """Yardstick: the decoder's two products for all T*R samples as
    torch.matmul calls (cuBLAS), without activations or the composite;
    (call ms, device ms)."""
    feats, t_vals, dnorm, w1t, b1, w2t, b2 = args
    CH, N, TC, C, R = feats.shape
    x = feats.permute(3, 0, 1, 2, 4).reshape(C, -1)
    w1 = w1t.to(feats.dtype)
    w2 = w2t.to(feats.dtype)

    def fn():
        return torch.matmul(w2, torch.matmul(w1, x))
    return cuda_ms(fn, reps), device_ms(fn, reps)


def timed_requests(request, n):
    """`n` calls of `request()` between CUDA events: (ms list, last output)."""
    times, out = [], None
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = request()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times, out


class PathCounts:
    """Each kernel's launches on each path.  `run(path, fn)` sets every
    wrapper's count to 0 just before `fn()` and adds the counts read just
    after to the path's; `by_path` holds only counts read so."""

    def __init__(self, kernels):
        self.kernels = kernels  # {name: wrapper with a `launches` count}
        self.by_path = {name: {} for name in kernels}

    def run(self, path, fn):
        for k in self.kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for name, k in self.kernels.items():
            self.by_path[name][path] = self.by_path[name].get(path, 0) + k.launches
        return out

    def requests(self, path, request, n, per_request):
        """`n` timed requests, each one step of `path`; after the i-th the
        path's counts must be i times `per_request` ({name: launches} for
        every kernel).  Returns (ms list, last output)."""
        times, out = [], None
        for i in range(1, n + 1):
            t, out = self.run(path, lambda: timed_requests(request, 1))
            times += t
            got = {name: c[path] for name, c in self.by_path.items()}
            want = {name: i * per_request[name] for name in self.kernels}
            if got != want:
                raise AssertionError(f"{path} request {i}: launches {got}, "
                                     f"expected {want}")
        return times, out


def bf16_tree(tree):
    """A numpy param tree as torch.bfloat16 leaves (rounded to nearest
    even), which the checkpoint writer stores as bf16."""
    return {k: bf16_tree(v) if isinstance(v, dict) else torch.from_numpy(v).bfloat16()
            for k, v in tree.items()}


def check_state_equal(G, source, rounded):
    """Every parameter and buffer of `G` equals `source`'s, bit for bit,
    or `source`'s rounded to bf16 if `rounded`; returns the count."""
    want = source.state_dict()
    got = G.state_dict()
    if set(got) != set(want):
        raise AssertionError("the loaded generator's state names differ")
    for k, v in want.items():
        ref = v.bfloat16().float() if rounded else v
        if not torch.equal(got[k], ref):
            raise AssertionError(f"{k}: loaded values differ from the source")
    return len(want)


def phase_checkpoint(G, cfg, device, card):
    """Phase 11: `G` (built from `cfg`) written as f32 and as a bf16
    export, each read back through `build_app_generator`; returns the
    generator read from the f32 file and its app settings."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.apps.common import build_app_generator
    from pix2pix3d_tpu_torch.bridge import params_to_jax
    from pix2pix3d_tpu_torch.train.checkpoint import save_checkpoint

    tree = params_to_jax(G)
    exports = {"f32": {"G_ema": tree}, "bf16 export": {"G_ema": bf16_tree(tree)}}
    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, state in exports.items():
            path = os.path.join(tmp, name.replace(" ", "_") + ".ckpt")
            t1 = time.perf_counter()
            save_checkpoint(path, state, step=0, config={"g_config": cfg})
            t_write = time.perf_counter() - t1
            t1 = time.perf_counter()
            G_ld, app_ld = build_app_generator("seg2cat", checkpoint=path,
                                               device=device)
            torch.cuda.synchronize(device)
            t_read = time.perf_counter() - t1
            n = check_state_equal(G_ld, G, rounded=name != "f32")
            log(f"checkpoint {name}: {os.path.getsize(path) / 2**20:.1f} MiB, "
                f"write {t_write:.3f} s, read into build_app_generator "
                f"{t_read:.3f} s (generator built and moved to the card "
                f"included); {n} tensors equal the source "
                + ("bit for bit" if name == "f32" else "rounded to bf16")
                + f" [{card}]")
            loaded[name] = (G_ld, app_ld)
    phase_done("checkpoint", t0)
    return loaded["f32"]


def phase_apps(G_app, app, device, card, counts):
    """Phase 12: generate_sample, render_video, extract_semantic_mesh and an
    EditSession on `G_app`; neither kernel may launch."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.apps import extract_mesh as em
    from pix2pix3d_tpu_torch.apps.common import inference
    from pix2pix3d_tpu_torch.apps.edit import EditSession
    from pix2pix3d_tpu_torch.apps.generate_samples import (frontal_pose,
                                                           generate_sample)
    from pix2pix3d_tpu_torch.apps.generate_video import render_video

    res, nrr = G_app.img_resolution, app["neural_rendering_resolution"]
    gen = torch.Generator().manual_seed(3)
    mask_np = torch.randint(0, G_app.semantic_channels, (res, res, 1),
                            generator=gen).float().numpy()
    pose = frontal_pose("seg2cat", app, device)

    def request():
        return generate_sample(G_app, app, mask_np, pose, seed=1)

    request()  # warm-up
    times, outs = counts.requests("apps", request, 3, NO_LAUNCHES)
    check_outputs(outs, res, nrr, G_app.semantic_channels)
    log(f"apps generate_sample: 3 requests, per-request ms "
        f"{[round(t, 3) for t in times]} median {statistics.median(times):.3f}; "
        f"five outputs finite and of their shapes [{card}]")

    calls = []
    hook = G_app.backbone.synthesis.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        t1 = time.perf_counter()
        frames, _ = counts.run("apps", lambda: render_video(
            G_app, app, mask_np, pose, seed=1, n_frames=VIDEO_FRAMES,
            pivot=(0, 0, -0.06)))
        video_s = time.perf_counter() - t1
    finally:
        hook.remove()
    if len(calls) != 1:
        raise AssertionError(f"render_video ran the backbone {len(calls)} times")
    if len(frames) != VIDEO_FRAMES or frames[0].shape != (res, res, 3):
        raise AssertionError("render_video frames")
    log(f"apps render_video: {VIDEO_FRAMES} frames in {video_s * 1e3:.1f} ms, "
        f"{video_s * 1e3 / VIDEO_FRAMES:.1f} ms per frame (mapping and the one "
        f"backbone run included; frames copied to the host); backbone runs "
        f"{len(calls)} [{card}]")

    with inference():
        ws = G_app.mapping(
            torch.randn((1, G_app.z_dim), generator=gen).to(device), pose[None],
            {"mask": torch.from_numpy(mask_np)[None].to(device), "pose": pose[None]})
    t1 = time.perf_counter()
    grid, _ = counts.run("apps", lambda: em.sigma_field(
        G_app, ws, resolution=MESH_RESOLUTION))
    grid_s = time.perf_counter() - t1
    level = float(np.quantile(grid, 0.9))
    t1 = time.perf_counter()
    em.marching_cubes(grid, level)
    mc_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    verts, faces, colors = counts.run("apps", lambda: em.extract_semantic_mesh(
        G_app, ws, resolution=MESH_RESOLUTION, threshold=level))
    mesh_s = time.perf_counter() - t1
    if not len(faces) or colors.shape != (len(verts), 3):
        raise AssertionError("extract_semantic_mesh gave no mesh")
    log(f"apps extract_semantic_mesh at {MESH_RESOLUTION}^3, threshold {level:.4f} "
        f"(the grid's 90th percentile): sigma grid (backbone included) "
        f"{grid_s:.3f} s, marching cubes (host) on it {mc_s:.3f} s, whole call "
        f"{mesh_s:.3f} s; {len(verts)} vertices, {len(faces)} faces, "
        f"{len(np.unique(colors, axis=0))} vertex colors [{card}]")

    sess = EditSession(G_app, app, mask_np[..., 0], seed=0, radius=2.7,
                       pivot=(0, 0, -0.06))
    t1 = time.perf_counter()
    img0, sem0, _ = counts.run("apps", lambda: sess.render(yaw=0.0))
    first_s = time.perf_counter() - t1
    if (img0.shape != (res, res, 3) or not np.isfinite(img0).all()
            or sem0.shape != (res, res, G_app.semantic_channels)):
        raise AssertionError("EditSession render")
    ws_before = sess._ws
    t1 = time.perf_counter()
    img1, _, _ = counts.run("apps", lambda: sess.render(yaw=0.3))
    slider_s = time.perf_counter() - t1
    if sess._ws is not ws_before or np.allclose(img0, img1):
        raise AssertionError("EditSession: a slider move re-ran the mapping "
                             "or left the image unchanged")
    sess.paint(slice(res * 3 // 10, res * 6 // 10),
               slice(res * 3 // 10, res * 6 // 10), 3)
    if sess._ws is not None:
        raise AssertionError("EditSession: a brush edit kept ws")
    img2, _, _ = counts.run("apps", lambda: sess.render(yaw=0.0))
    if np.allclose(img0, img2):
        raise AssertionError("EditSession: the edit left the image unchanged")
    log(f"apps EditSession: first render (mapping + backbone) {first_s * 1e3:.1f} "
        f"ms, slider render on cached planes {slider_s * 1e3:.1f} ms; checks of "
        f"tests/test_edit_session.py hold [{card}]")
    phase_done("apps", t0)


def phase_apps_serving(G_app, app, device, card, counts):
    """Phase 13: `G_app` with the serving rendering keys; decode_composite
    launches once per `generate_sample`."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.apps.generate_samples import (frontal_pose,
                                                           generate_sample)

    res, nrr = G_app.img_resolution, app["neural_rendering_resolution"]
    mask_np = torch.randint(0, G_app.semantic_channels, (res, res, 1),
                            generator=torch.Generator().manual_seed(4)).float().numpy()
    pose = frontal_pose("seg2cat", app, device)
    G_app.rendering_kwargs.update(config.SERVING_RENDERING)

    def request():
        return generate_sample(G_app, app, mask_np, pose, seed=1)

    request()  # warm-up
    times, outs = counts.requests("apps-serving", request, 3,
                                  ONE_DECODE_COMPOSITE)
    check_outputs(outs, res, nrr, G_app.semantic_channels)
    log(f"apps-serving generate_sample: 3 requests, decode_composite launches "
        f"{counts.by_path['decode_composite']['apps-serving']}, "
        f"late_separate_decode "
        f"{counts.by_path['late_separate_decode']['apps-serving']}; per-request "
        f"ms {[round(t, 3) for t in times]} median {statistics.median(times):.3f}; "
        f"outputs finite [{card}]")
    phase_done("apps-serving", t0)


def phase_released(device, card, counts):
    """Phase 14: one `generate_sample` of seg2face and of edge2car, full
    width, random weights."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.apps.common import build_app_generator
    from pix2pix3d_tpu_torch.apps.generate_samples import (frontal_pose,
                                                           generate_sample)

    gen = torch.Generator().manual_seed(5)
    for name in ("seg2face", "edge2car"):
        G, app = build_app_generator(name, device=device, seed=0)
        res, nrr = G.img_resolution, app["neural_rendering_resolution"]
        if G.data_type == "edge":
            mask = (torch.rand((res, res, 1), generator=gen) > 0.9).float() * 255
            if not (G.rendering_kwargs["white_back"] and nrr == 64):
                raise AssertionError(f"{name}: white_back and nrr 64 expected")
        else:
            mask = torch.randint(0, G.semantic_channels, (res, res, 1),
                                 generator=gen).float()
        pose = frontal_pose(name, app, device)
        t, out = counts.run(name, lambda: timed_requests(
            lambda: generate_sample(G, app, mask.numpy(), pose, seed=2), 1))
        check_outputs(out, res, nrr, G.semantic_channels)
        log(f"{name}: {sum(p.numel() for p in G.parameters()) / 1e6:.1f} M params, "
            f"{res}^2, {G.semantic_channels} semantic channels, nrr {nrr}, "
            f"{type(G.backbone.mapping).__name__}; first request {t[0]:.1f} ms "
            f"(cuDNN autotuning included); outputs finite and of their shapes "
            f"[{card}]")
        del G, out
        torch.cuda.empty_cache()
    phase_done("released configs", t0)


# phase train-parity: the small training configuration of the CPU tests
# (tests/test_torch_train_phases.py, tests/test_loss_gating.py::_tiny_loss)
TINY_RES, TINY_NRR, TINY_B = 128, 16, 2
TINY_LOSS = dict(r1_gamma=5.0, random_c_prob=0.5, lambda_l1=1.0, lambda_lpips=1.0,
                 blur_init_sigma=10, blur_fade_kimg=25, lambda_D_semantic=0.1,
                 only_raw_recons=True, lambda_cross_view=1e-4,
                 neural_rendering_resolution_initial=TINY_NRR)
TINY_D = dict(c_dim=25, img_resolution=TINY_RES, channel_base=512, channel_max=16,
              num_fp16_res=0, epilogue_kwargs={"mbstd_group_size": 2})
# the seg2cat training recipe (README.md's flags; train.py's defaults for
# the rest): generator, discriminators and loss as the port's CLI builds them
RECIPE_FLAGS = ["--cfg", "afhq", "--data_type", "seg", "--batch", "4", "--gamma", "5",
                "--semantic_channels", "6", "--render_mask", "True", "--dis_mask", "True",
                "--neural_rendering_resolution_initial", "128", "--gen_pose_cond", "True",
                "--random_c_prob", "0.5", "--lambda_d_semantic", "0.1",
                "--lambda_lpips", "1", "--lambda_cross_view", "1e-4",
                "--only_raw_recons", "True"]
TRAIN_IMAGES = 16
TRAIN_STEPS = 4
# R1 through the bf16 blocks (train-parity): relative L2 per weight and of
# the input gradients, and every leaf's largest difference as a share of
# the network's largest gradient entry (tests/test_torch_train_bf16.py).
# bf16 against f32: JAX's own bf16 R1 lies 0.06-0.09 (relative L2) and 0.10
# from its f32 on the CPU, so 0.2 and 0.1; f32 gradfix against F.conv2d's
# double backward: other summation orders only, 1e-3 and 1e-4
R1_TOL = {"bf16": (0.2, 0.1), "f32": (1e-3, 1e-4)}

def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def compare_states(a, b, frac_tol, abs_tol=1e-5):
    """Per network of two `Trainer.state_tree()`s: every leaf finite, and
    the share of entries that differ by more than `abs_tol` at most
    `frac_tol`; returns {net: (max |diff|, share above abs_tol)}."""
    out = {}
    for net in ("G", "D", "D_semantic", "G_ema"):
        la, lb = dict(_tree_leaves(a[net])), dict(_tree_leaves(b[net]))
        if set(la) != set(lb):
            raise AssertionError(f"{net}: the states' leaves differ")
        n = above = 0
        worst = 0.0
        for k, x in la.items():
            if not (np.isfinite(x).all() and np.isfinite(lb[k]).all()):
                raise AssertionError(f"{net} {k}: non-finite values")
            d = np.abs(x - lb[k])
            worst = max(worst, float(d.max()))
            above += int((d > abs_tol).sum())
            n += d.size
        if above > frac_tol * n:
            raise AssertionError(f"{net}: {above} of {n} entries differ by more "
                                 f"than {abs_tol} (max {worst:.3e})")
        out[net] = (worst, above / n)
    return out


def compare_adam(a, b, scale):
    """Each network's Adam mu and nu per leaf: |diff| <= scale * max|ref|
    (+1e-6 for mu, +1e-12 for nu), and equal counts."""
    for net in ("G", "D", "D_semantic"):
        sa, sb = a[f"opt_{net}"]["0"], b[f"opt_{net}"]["0"]
        if int(sa["count"]) != int(sb["count"]):
            raise AssertionError(f"{net}: Adam counts {sa['count']} != {sb['count']}")
        for moment, floor, sc in (("mu", 1e-6, scale), ("nu", 1e-12, 2 * scale)):
            ref = dict(_tree_leaves(sb[moment]))
            for k, x in _tree_leaves(sa[moment]):
                err = float(np.abs(x - ref[k]).max())
                if not err <= sc * float(np.abs(ref[k]).max()) + floor:
                    raise AssertionError(f"{net} Adam {moment} {k}: {err:.3e}")


def device_state_diff(a, b, optimizers=False):
    """{network: max |diff|} between two trainers' parameters and buffers
    (and, with `optimizers`, their Adam moments and steps), on the card."""
    out = {}
    for key, (ma, oa) in a.networks().items():
        mb, ob = b.networks()[key]
        sb = mb.state_dict()
        d = max(float((v.float() - sb[k].float()).abs().max())
                for k, v in ma.state_dict().items())
        if optimizers and oa is not None:
            for pa, pb in zip(ma.parameters(), mb.parameters()):
                for name in ("exp_avg", "exp_avg_sq", "step"):
                    d = max(d, float((oa.state[pa][name].float()
                                      - ob.state[pb][name].float()).abs().max()))
        out[key] = d
    return out


def r1_gradients(D, img, raw, c):
    """R1 of `D` at these inputs: ({parameter: gradient of the penalty
    sum(|dD/dimage|^2) + sum(|dD/dimage_raw|^2)}, (both input gradients)),
    f32; parameters the penalty does not reach are left out."""
    img, raw = img.clone().requires_grad_(True), raw.clone().requires_grad_(True)
    out = D({"image": img, "image_raw": raw}, c).sum()
    gi, gr = torch.autograd.grad(out, [img, raw], create_graph=True)
    pen = gi.float().square().sum() + gr.float().square().sum()
    names = [n for n, _ in D.named_parameters()]
    grads = torch.autograd.grad(pen, list(D.parameters()), allow_unused=True)
    return ({n: g.float() for n, g in zip(names, grads) if g is not None},
            (gi.detach().float(), gr.detach().float()))


def r1_apart(got, want):
    """(largest relative L2 over the weights and both input gradients,
    largest |difference| of any leaf / the largest entry of `want`)."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    scale = max(float(g.abs().max()) for g in want[0].values())
    if set(got[0]) != set(want[0]):
        raise AssertionError("R1 reaches other parameters")
    l2 = max([rel(got[0][n], w) for n, w in want[0].items() if n.endswith("weight")]
             + [rel(a, b) for a, b in zip(got[1], want[1])])
    share = max(float((got[0][n] - w).abs().max()) for n, w in want[0].items()) / scale
    return l2, share


def check_r1_bf16(device, card):
    """R1 through the recipe's bf16 discriminator blocks (num_fp16_res 4,
    conv_clamp 256) at the small width, on the card: the port's gradfix
    convolutions against `F.conv2d`'s own double backward in f32, and the
    bf16 blocks against the same weights in f32, each within R1_TOL;
    PyTorch's own bf16 double backward against f32 is printed."""
    from pix2pix3d_tpu_torch.models.triplane import init_parameters
    from pix2pix3d_tpu_torch.nn.discriminator import DualDiscriminator
    from pix2pix3d_tpu_torch.ops import conv2d_gradfix

    kw = dict(TINY_D, num_fp16_res=4, conv_clamp=256)
    D16 = DualDiscriminator(img_channels=3, **kw)
    init_parameters(D16, torch.Generator().manual_seed(5))
    D32 = DualDiscriminator(img_channels=3, **dict(kw, num_fp16_res=0))
    D32.load_state_dict(D16.state_dict())
    D16, D32 = D16.to(device), D32.to(device)
    rng = np.random.RandomState(4)
    img, raw, c = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
                   for shape in ((TINY_B, 3, TINY_RES, TINY_RES),
                                 (TINY_B, 3, TINY_NRR, TINY_NRR), (TINY_B, 25)))
    runs, ms = {}, {}
    for name, D, enabled in (("f32", D32, True), ("f32 plain", D32, False),
                             ("bf16", D16, True), ("bf16 plain", D16, False)):
        conv2d_gradfix.enabled = enabled
        try:
            r1_gradients(D, img, raw, c)      # cuDNN's first calls
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            runs[name] = r1_gradients(D, img, raw, c)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t1) * 1e3
        finally:
            conv2d_gradfix.enabled = True
    for got, want, (l2_tol, share_tol) in (
            ("f32", "f32 plain", R1_TOL["f32"]), ("bf16", "f32", R1_TOL["bf16"])):
        l2, share = r1_apart(runs[got], runs[want])
        if not (l2 <= l2_tol and share <= share_tol):
            raise AssertionError(f"R1 {got} vs {want}: relative L2 {l2:.3e} (gate "
                                 f"{l2_tol}), largest difference {share:.3e} of the "
                                 f"largest entry (gate {share_tol})")
        log(f"train-parity R1 {got} (gradfix) vs {want}: relative L2 {l2:.3e} (gate "
            f"{l2_tol}), largest difference {share:.3e} of the largest entry (gate "
            f"{share_tol}) [{card}]")
    l2, share = r1_apart(runs["bf16 plain"], runs["f32"])
    log(f"train-parity R1 bf16 through F.conv2d's own double backward vs f32: "
        f"relative L2 {l2:.3e}, largest difference {share:.3e} (not gated); one R1 "
        f"ms: " + ", ".join(f"{n} {t:.1f}" for n, t in ms.items()) + f" [{card}]")


def phase_train_parity(device, card):
    """Phase 15: one `Trainer.step` at step_idx 0 (cross-view renders, all
    six phases, EMA) of the small training configuration on the card and on
    the CPU, f32 with TF32 off, from equal weights and equal CPU generators
    (so both devices see the same random numbers)."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.models.triplane import init_parameters
    from pix2pix3d_tpu_torch.nn.discriminator import DualDiscriminator
    from pix2pix3d_tpu_torch.ops import precision
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler,
                                                   fov_to_intrinsics,
                                                   pose_to_conditioning)
    from pix2pix3d_tpu_torch.train.loss import Pix2Pix3DLoss
    from pix2pix3d_tpu_torch.train.lpips import LPIPS
    from pix2pix3d_tpu_torch.train.trainer import Trainer

    cfg = config.generator_config(cfg="afhq", resolution=TINY_RES, data_type="seg",
                                  semantic_channels=6, cbase=512, cmax=16,
                                  sr_num_fp16_res=0, render_mask=True,
                                  gen_pose_cond=True)
    cfg["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4)
    cfg["mapping_kwargs"]["in_resolution"] = TINY_RES
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    rng = np.random.RandomState(0)
    c2w = LookAtPoseSampler.sample(np.pi / 2, np.pi / 2, [0, 0, -0.06], radius=2.7,
                                   batch_size=TINY_B, device="cpu")
    pose = pose_to_conditioning(c2w, fov_to_intrinsics(18.837, device="cpu"))
    batch = {"image": torch.from_numpy(rng.rand(TINY_B, TINY_RES, TINY_RES, 3)
                                       .astype(np.float32) * 2 - 1),
             "mask": torch.from_numpy(rng.randint(0, 6, (TINY_B, TINY_RES, TINY_RES, 1))
                                      .astype(np.float32)),
             "pose": pose}
    gen_z = torch.from_numpy(rng.randn(4, TINY_B, 512).astype(np.float32))
    gen_c = pose[None].repeat(4, 1, 1)

    def run(dev):
        G = build_generator(device="cpu", seed=0, train=True, **cfg)
        D = DualDiscriminator(img_channels=3, **TINY_D)
        Ds = DualDiscriminator(img_channels=9, **TINY_D)
        gen = torch.Generator().manual_seed(1)
        init_parameters(D, gen)
        init_parameters(Ds, gen)
        loss = Pix2Pix3DLoss(G.to(dev), D.to(dev), D_semantic=Ds.to(dev),
                             lpips=LPIPS().to(dev), **TINY_LOSS)
        trainer = Trainer(loss)
        t1 = time.perf_counter()
        stats = trainer.step({k: v.to(dev) for k, v in batch.items()}, gen_z.to(dev),
                             gen_c.to(dev), torch.Generator().manual_seed(3),
                             step_idx=0, cur_nimg=0, batch_size=TINY_B)
        return stats, trainer.state_tree(), (time.perf_counter() - t1) * 1e3

    with precision.policy(False):
        s_gpu, st_gpu, ms_gpu = run(device)
        s_cpu, st_cpu, ms_cpu = run(torch.device("cpu"))
        check_r1_bf16(device, card)
    if set(s_gpu) != set(s_cpu) or len(s_gpu) < 14:
        raise AssertionError(f"stats differ: {sorted(set(s_gpu) ^ set(s_cpu))}")
    for k in s_cpu:
        if not np.isfinite(s_gpu[k]).all():
            raise AssertionError(f"{k}: non-finite on the card")
        if not np.all(np.abs(s_gpu[k] - s_cpu[k]) <= 1e-3 * np.abs(s_cpu[k]) + 1e-5):
            raise AssertionError(f"{k}: card {s_gpu[k]} vs CPU {s_cpu[k]}")
    compare_adam(st_gpu, st_cpu, 1e-2)
    diffs = compare_states(st_gpu, st_cpu, frac_tol=0.02)
    log(f"train-parity: {len(s_cpu)} stats (every phase's loss and scores) agree "
        f"card vs CPU to 1e-3 relative + 1e-5; Adam mu/nu per leaf to 1e-2 (2e-2) "
        f"of the leaf's largest; step {ms_gpu:.1f} ms on the card, {ms_cpu:.1f} ms "
        f"on the CPU [{card}]")
    for net, (d, share) in diffs.items():
        log(f"train-parity {net}: max |card - CPU| {d:.3e}; share of entries "
            f"above 1e-5: {share:.5f} (gate 0.02)")
    phase_done("train-parity", t0)


def write_training_folder(root, n, res=512, classes=6):
    """A seeded synthetic seg2cat folder: `n` RGB images and 6-class masks
    as PNGs (the port's encoder) and `LookAtPoseSampler` poses in
    dataset.json; returns (image dir, mask dir)."""
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler,
                                                   fov_to_intrinsics,
                                                   pose_to_conditioning)
    from pix2pix3d_tpu_torch.utils.png import write_png
    imgs, masks = os.path.join(root, "imgs"), os.path.join(root, "masks")
    os.makedirs(imgs)
    os.makedirs(masks)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:res, 0:res] / res
    labels = []
    intr = fov_to_intrinsics(18.837, device="cpu")
    for i in range(n):
        name = f"img{i:05d}.png"
        base = rng.rand(3)[:, None, None] * np.stack([xx, yy, 1 - xx])
        img = np.clip(base.transpose(1, 2, 0) * 255 + rng.randint(0, 32, (res, res, 3)),
                      0, 255).astype(np.uint8)
        write_png(os.path.join(imgs, name), img, level=1)
        r = np.hypot(xx - 0.5, yy - 0.5)
        mask = np.minimum((r * classes * (1 + 0.2 * rng.rand())).astype(np.uint8),
                          classes - 1)
        write_png(os.path.join(masks, name), mask, level=1)
        c2w = LookAtPoseSampler.sample(np.pi / 2 + rng.uniform(-0.4, 0.4),
                                       np.pi / 2 + rng.uniform(-0.2, 0.2),
                                       [0, 0, -0.06], radius=2.7, device="cpu")
        labels.append([name, pose_to_conditioning(c2w, intr)[0].tolist()])
    with open(os.path.join(imgs, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return imgs, masks


def profile_step(step, ranges, host):
    """`step()` under torch.profiler, with host activity too if `host`:
    (wall ms, device busy ms, {range: device span ms}, the 8 costliest
    device ops as (name, ms, count)).  `ranges` are the `record_function`
    ranges the step opens; with host activity the profiler gives each a
    device span (its first kernel to its last, the backward's included),
    which the busy time leaves out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    device = {e.key: e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    ops = [e for k, e in device.items() if k not in ranges]
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    if busy == 0:
        raise AssertionError("the profiler recorded no device time")
    spans = {k: device[k].self_device_time_total / 1e3 for k in ranges if k in device}
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return wall, busy, spans, [(e.key, e.self_device_time_total / 1e3, e.count)
                               for e in top]


def cuda_generator(state):
    """A `torch.Generator` on the card in `state` (`get_state()`'s)."""
    gen = torch.Generator(device="cuda")
    gen.set_state(state)
    return gen


def deterministic_steps(trainers, inputs, gen_state, kw):
    """One `Trainer.step` on each trainer, from the same inputs and
    generator state, under PyTorch's deterministic algorithms (cuDNN's
    deterministic ones, the gathers' backward without atomics); returns
    (their stats, the ops PyTorch flagged as having no deterministic
    version), restoring the settings."""
    import warnings

    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    stats = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for tr in trainers:
                stats.append(tr.step(*inputs, cuda_generator(gen_state), **kw))
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old[2:4]
        if old[4] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old[4]
    flagged = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
    return stats, flagged


def phase_train(device, card, counts):
    """Phase 16: the seg2cat training recipe at full width through the
    port's CLI (`main` with the recipe's flags, as `python -m
    pix2pix3d_tpu_torch.train` runs it; random weights from seed 0, a
    synthetic folder): steps 0-3, step 0 with every phase, each timed; a
    resume check and a profiled step on copies of the trainer before step
    2; the run's outputs."""
    t0 = time.time()
    import copy
    from pix2pix3d_tpu_torch.models.triplane import STAGES
    from pix2pix3d_tpu_torch.train import __main__ as cli
    from pix2pix3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from pix2pix3d_tpu_torch.train.loop import build_training
    from pix2pix3d_tpu_torch.train.trainer import Trainer

    record = {"ms": [], "peak": []}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        imgs, masks = write_training_folder(tmp, TRAIN_IMAGES)
        log(f"train: {TRAIN_IMAGES} synthetic 512^2 images and masks written in "
            f"{time.perf_counter() - t1:.2f} s")
        # steps 0-3 at batch 4, one tick at their end with its image grids
        # and network snapshot
        argv = (["--outdir", os.path.join(tmp, "runs"), "--data", imgs,
                 "--mask_data", masks] + RECIPE_FLAGS
                + ["--kimg", str(4 * TRAIN_STEPS / 1e3), "--tick",
                   str(4 * TRAIN_STEPS / 1e3), "--snap", "1"])
        conf = cli.run_config(cli.parser().parse_args(argv))

        def resume_copies(trainer):
            """The full training state through a checkpoint file into a
            fresh trainer (equal bit for bit), and an in-memory copy."""
            path = os.path.join(tmp, "state.ckpt")
            t2 = time.perf_counter()
            save_checkpoint(path, trainer.state_tree(), step=8)
            t_w = time.perf_counter() - t2
            fresh = build_training(conf["g_config"], 25, d_kwargs=conf["d_kwargs"],
                                   loss_kwargs=conf["loss_kwargs"], device=device,
                                   random_seed=123)
            t2 = time.perf_counter()
            tree, step = load_checkpoint(path, fresh.state_tree())
            fresh.load_state_tree(tree)
            t_r = time.perf_counter() - t2
            size = os.path.getsize(path)
            os.remove(path)
            del tree
            reloaded = device_state_diff(trainer, fresh, optimizers=True)
            if any(reloaded.values()) or step != 8:
                raise AssertionError(f"reloaded state differs: {reloaded}, step {step}")
            log(f"train resume: full training state {size / 2**30:.2f} GiB, write "
                f"{t_w:.2f} s (state to the host included), read + load {t_r:.2f} s "
                f"(the template from the fresh trainer included); the fresh "
                f"trainer's state equals the saved one bit for bit [{card}]")
            return fresh, copy.deepcopy(trainer)

        def check_resume(trainer, stats, fresh, twin, inputs, gen_state, kw):
            """Step 2 from the reloaded state and from the in-memory copy,
            both deterministic: equal bit for bit.  The loop's own step 2
            (default algorithms) against them is printed."""
            (s_fresh, s_twin), flagged = deterministic_steps(
                (fresh, twin), inputs, gen_state, kw)
            diffs = device_state_diff(twin, fresh, optimizers=True)
            same = all(np.array_equal(s_fresh[k], s_twin[k]) for k in s_twin)
            if any(diffs.values()) or not same or set(s_fresh) != set(stats):
                raise AssertionError(f"resumed step 2 differs from the uninterrupted "
                                     f"one: {diffs}, stats equal {same}; ops without "
                                     f"a deterministic version: {flagged}")
            spread = device_state_diff(trainer, twin)
            log(f"train resume: step 2 from the checkpoint equals step 2 from the "
                f"in-memory state bit for bit (parameters, buffers, Adam moments "
                f"and counts, stats), both under deterministic algorithms; ops "
                f"flagged as without a deterministic version: {flagged or 'none'}; "
                f"the loop's own step 2 (default algorithms) apart from them by "
                + "; ".join(f"{n} {d:.2e}" for n, d in spread.items()) + f" [{card}]")

        def profiled_steps(tr, inputs, generator, kw):
            """One step without the reg phases under the profiler, device
            activity only, after one unprofiled warm-up step of the same
            trainer (its first step allocates): the idle share.  (Each
            phase's device span comes from phase 17's profiled step with
            host activity, on the same recipe with augmentation: tracing the
            host costs ~45 s a step.)"""
            tr.step(*inputs, generator, **dict(kw, step_idx=5))
            wall, busy, _, top = profile_step(
                lambda: tr.step(*inputs, generator, **dict(kw, step_idx=5)),
                [f"phase_{n}" for n in PHASES_NO_REG] + list(STAGES), False)
            log(f"train: a step with no reg phases under the profiler (device "
                f"activity): wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
                f"{1 - busy / wall:.3f} [{card}]")
            for key, ms, count in top:
                log(f"  {ms:8.3f} ms {count:5d}x  {key[:90]}")

        def step_fn(trainer, batch, gen_z, gen_c, generator, **kw):
            tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            if tf32 != (False, False):
                raise AssertionError(f"the training loop runs with TF32 {tf32}")
            idx = kw["step_idx"]
            if idx == 0:
                record["w_avg0"] = trainer.G.backbone.mapping.w_avg.clone()
            if idx == 2:
                fresh, twin = resume_copies(trainer)
                gen_state = generator.get_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t2 = time.perf_counter()
            stats = Trainer.step(trainer, batch, gen_z, gen_c, generator, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t2) * 1e3
            record["ms"].append(wall)
            record["peak"].append(torch.cuda.max_memory_allocated())
            log(f"train step {idx}: {wall:.1f} ms, peak "
                f"{record['peak'][-1] / 2**30:.2f} GiB [{card}]")
            for k, v in stats.items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"step {idx}: {k} not finite: {v}")
            if idx == 0:
                moved = (trainer.G.backbone.mapping.w_avg - record["w_avg0"]).abs().max()
                if not moved > 0:
                    raise AssertionError("w_avg did not move in step 0")
                log(f"train: w_avg moved by up to {float(moved):.3e} in step 0")
            if idx == 1:
                g, e = trainer.G.state_dict(), trainer.G_ema.state_dict()
                diff = max(float((g[k] - e[k]).abs().max()) for k in g)
                if not diff > 0:
                    raise AssertionError("G_ema equals G after step 1")
                log(f"train: G_ema differs from G after step 1 by up to {diff:.3e}")
            if idx == 2:
                inputs = (batch, gen_z, gen_c)
                check_resume(trainer, stats, fresh, twin, inputs, gen_state, kw)
                del twin
                torch.cuda.empty_cache()
                profiled_steps(fresh, inputs, cuda_generator(gen_state), kw)
                del fresh
                torch.cuda.empty_cache()
            return stats

        run_dir = counts.run("train", lambda: cli.main(argv, step_fn=step_fn))
        files = set(os.listdir(run_dir))
        for name in ("stats.jsonl", "reals.png", "mask.png", "fakes000000.png",
                     "fakes000000_label.png", "fakes000000_mv.png",
                     "network-snapshot-000000.ckpt", "network-final.ckpt"):
            if name not in files:
                raise AssertionError(f"train: {name} not written")
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            ticks = [json.loads(line) for line in f]
        if not ticks or not all(np.isfinite(v) for v in ticks[-1].values()):
            raise AssertionError("stats.jsonl holds no finite tick")
    torch.cuda.empty_cache()
    for name, by_path in counts.by_path.items():
        if by_path["train"]:
            raise AssertionError(f"training launched {name} {by_path['train']} times")
    if len(record["ms"]) != TRAIN_STEPS:
        raise AssertionError(f"{len(record['ms'])} steps ran, not {TRAIN_STEPS}")
    med = statistics.median(record["ms"][1:])
    TRAIN_RESULTS["train"] = dict(record, median=med)
    log(f"train: step 0 (every phase) {record['ms'][0]:.1f} ms; steps 1-3 "
        + ", ".join(f"{m:.1f}" for m in record["ms"][1:]) + f" ms, median {med:.1f} ms; "
        f"{4 / med * 1e3:.2f} images/s at batch 4 (steps 1-3, none profiled); peak "
        f"max_memory_allocated {max(record['peak']) / 2**30:.2f} GiB [{card}]")
    log(f"train: stats.jsonl tick: Loss/G/loss {ticks[-1]['Loss/G/loss']:.4f}, "
        f"Loss/D/loss {ticks[-1]['Loss/D/loss']:.4f}; grids, network snapshot and "
        f"network-final.ckpt written; both kernels' launch counts 0 on this path")
    phase_done("train", t0)


# ---------------------------------------------------------------------------
# phases 17-21 (the rest of the one-card trainer)

# phase 17's fixed augmentation probability and ADA run (8 steps, ticks of
# 4); the ADA target -1.5 lies below any mean of signs, so that p moves up
# at every update (from random weights E[sign(D(real))] lies below
# train.py's 0.6, and p would stay clipped at 0)
AUG_FLAGS = ["--aug", "fixed", "--p", "0.2"]
ADA_STEPS = 8
ADA_TARGET = -1.5
# small-width card-vs-CPU checks of phases 17-18: each leaf's largest
# difference within 1e-3 of the leaf's largest entry + 1e-6 (the tolerance
# of the CPU tests against JAX, tests/test_torch_train_phases.py: other
# summation orders, amplified by R1's double backward), the loss 1e-4
SMALL_GRAD_TOL, SMALL_LOSS_TOL = 1e-3, 1e-4
# the results of phase 16, for the phases that compare with it
TRAIN_RESULTS = {}
# the trainer's `phase_*` ranges: every phase (step_idx 16), and a step
# without the reg phases (step_idx 5)
PHASES = ("cv_prep", "gmain", "greg", "dmain", "dreg", "dsmain", "dsreg", "ema")
PHASES_NO_REG = ("cv_prep", "gmain", "dmain", "dsmain", "ema")


def crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = crc32c_table()


def masked_crc(data):
    """TFRecord's masked CRC-32C, independent of the port's writer."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tb_records(path):
    """The payloads of a TensorBoard event file; each record's length and
    data CRCs must hold."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        if struct.unpack("<I", data[i + 8:i + 12])[0] != masked_crc(header):
            raise AssertionError(f"{path}: record {len(out)} length CRC")
        payload = data[i + 12:i + 12 + length]
        if struct.unpack("<I", data[i + 12 + length:i + 16 + length])[0] \
                != masked_crc(payload):
            raise AssertionError(f"{path}: record {len(out)} data CRC")
        out.append(payload)
        i += 16 + length
    return out


def small_loss(device, aug=None, rendering=None, **loss_kw):
    """The small training configuration of phase 15 on `device` (weights
    from the same seeds on every device), with an augmentation pipe of
    `aug` kwargs, extra rendering keys and loss settings."""
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.models.triplane import init_parameters
    from pix2pix3d_tpu_torch.nn.discriminator import DualDiscriminator
    from pix2pix3d_tpu_torch.train.augment import AugmentPipe
    from pix2pix3d_tpu_torch.train.loss import Pix2Pix3DLoss
    from pix2pix3d_tpu_torch.train.lpips import LPIPS

    cfg = config.generator_config(cfg="afhq", resolution=TINY_RES, data_type="seg",
                                  semantic_channels=6, cbase=512, cmax=16,
                                  sr_num_fp16_res=0, render_mask=True,
                                  gen_pose_cond=True)
    cfg["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4,
                                   **(rendering or {}))
    cfg["mapping_kwargs"]["in_resolution"] = TINY_RES
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    G = build_generator(device="cpu", seed=0, train=True, **cfg)
    D = DualDiscriminator(img_channels=3, **TINY_D)
    Ds = DualDiscriminator(img_channels=9, **TINY_D)
    gen = torch.Generator().manual_seed(1)
    init_parameters(D, gen)
    init_parameters(Ds, gen)
    pipe = None if aug is None else AugmentPipe(**aug)
    return Pix2Pix3DLoss(G.to(device), D.to(device), D_semantic=Ds.to(device),
                         lpips=LPIPS().to(device), augment_pipe=pipe,
                         **dict(TINY_LOSS, **loss_kw))


def small_batch(device, b=TINY_B):
    """Phase 15's small batch (its first `b` images), latents and random
    poses, on `device`."""
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler,
                                                   fov_to_intrinsics,
                                                   pose_to_conditioning)
    rng = np.random.RandomState(0)
    c2w = LookAtPoseSampler.sample(np.pi / 2, np.pi / 2, [0, 0, -0.06], radius=2.7,
                                   batch_size=TINY_B, device="cpu")
    pose = pose_to_conditioning(c2w, fov_to_intrinsics(18.837, device="cpu"))
    batch = {"image": torch.from_numpy(rng.rand(TINY_B, TINY_RES, TINY_RES, 3)
                                       .astype(np.float32) * 2 - 1),
             "mask": torch.from_numpy(rng.randint(0, 6, (TINY_B, TINY_RES, TINY_RES, 1))
                                      .astype(np.float32)),
             "pose": pose}
    c2w_r = LookAtPoseSampler.sample(np.pi / 2 + 0.4, np.pi / 2 - 0.2, [0, 0, -0.06],
                                     radius=2.7, batch_size=TINY_B, device="cpu")
    gen_c = pose_to_conditioning(c2w_r, fov_to_intrinsics(18.837, device="cpu"))
    gen_z = torch.from_numpy(rng.randn(TINY_B, 512).astype(np.float32))
    return ({k: v[:b].to(device) for k, v in batch.items()}, gen_z[:b].to(device),
            gen_c[:b].to(device))


def phase_grads(loss, module, fn):
    """(loss value, {parameter: gradient}) of `fn()` (a phase returning
    (loss, aux)) w.r.t. `module`, the other networks frozen."""
    from pix2pix3d_tpu_torch.train.trainer import _set_trainable
    nets = (loss.G, loss.D, loss.D_semantic)
    _set_trainable(module, nets)
    value, _ = fn(loss)
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
    _set_trainable(None, nets)
    return float(value.detach()), {
        k: (torch.zeros_like(p) if g is None else g).float().cpu()
        for (k, p), g in zip(params.items(), grads)}


def card_vs_cpu(label, device, card, build, module_of, fn, b=TINY_B):
    """One phase on the card and on the CPU at the small width, f32 with
    TF32 off, from equal weights and equal CPU generators: the loss within
    SMALL_LOSS_TOL, each gradient leaf within SMALL_GRAD_TOL of its largest
    entry; returns the largest share."""
    from pix2pix3d_tpu_torch.ops import precision
    out = []
    with precision.policy(False):
        for dev in (device, torch.device("cpu")):
            loss = build(dev)
            out.append(phase_grads(loss, module_of(loss),
                                   lambda L: fn(L, *small_batch(dev, b),
                                                torch.Generator().manual_seed(9))))
            del loss
    (v_gpu, g_gpu), (v_cpu, g_cpu) = out
    if not (math.isfinite(v_gpu) and abs(v_gpu - v_cpu) <= SMALL_LOSS_TOL * abs(v_cpu)):
        raise AssertionError(f"{label}: loss card {v_gpu} vs CPU {v_cpu}")
    worst = 0.0
    for k, w in g_cpu.items():
        g = g_gpu[k]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {k} gradient not finite on the card")
        share = float((g - w).abs().max()) / (float(w.abs().max()) + 1e-6 / SMALL_GRAD_TOL)
        if share > SMALL_GRAD_TOL:
            raise AssertionError(f"{label}: {k} gradient apart by {share:.3e} of its "
                                 f"largest entry (gate {SMALL_GRAD_TOL})")
        worst = max(worst, share)
    log(f"{label}: card vs CPU at the small width (f32, TF32 off): loss {v_gpu:.6f} vs "
        f"{v_cpu:.6f}; {len(g_cpu)} gradient leaves, largest difference {worst:.3e} of "
        f"the leaf's largest entry (gate {SMALL_GRAD_TOL}) [{card}]")
    return worst


def run_recipe(path, flags, folder, tmp, device, card, counts, after=None,
               steps=TRAIN_STEPS, tick_steps=None, loop_overrides=None):
    """The seg2cat recipe with `flags` for `steps` steps at batch 4 through
    the port's CLI (`main`; with `loop_overrides`, `run_config`'s kwargs
    with those changes into `training_loop`), every step timed alone, its
    peak memory and finite stats; `after(trainer, inputs, gen_state, kw,
    stats)` runs after each step (the generator's state as the step found
    it).  Returns (run directory, {"ms", "peak"})."""
    from pix2pix3d_tpu_torch.train import __main__ as cli
    from pix2pix3d_tpu_torch.train.loop import training_loop
    from pix2pix3d_tpu_torch.train.trainer import Trainer

    imgs, masks = folder
    tick = 4 * (tick_steps or steps) / 1e3
    argv = (["--outdir", os.path.join(tmp, path), "--data", imgs, "--mask_data", masks]
            + RECIPE_FLAGS + flags
            + ["--kimg", str(4 * steps / 1e3), "--tick", str(tick), "--snap", "1"])
    rec = {"ms": [], "peak": []}

    def step_fn(trainer, batch, gen_z, gen_c, generator, **kw):
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        if tf32 != (False, False):
            raise AssertionError(f"the training loop runs with TF32 {tf32}")
        gen_state = generator.get_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        stats = Trainer.step(trainer, batch, gen_z, gen_c, generator, **kw)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t1) * 1e3)
        rec["peak"].append(torch.cuda.max_memory_allocated())
        idx = kw["step_idx"]
        log(f"{path} step {idx}: {rec['ms'][-1]:.1f} ms, peak "
            f"{rec['peak'][-1] / 2**30:.2f} GiB [{card}]")
        for k, v in stats.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"{path} step {idx}: {k} not finite: {v}")
        if after is not None:
            after(trainer, (batch, gen_z, gen_c), gen_state, kw, stats)
        return stats

    if loop_overrides is None:
        run_dir = counts.run(path, lambda: cli.main(argv, step_fn=step_fn))
    else:
        conf = cli.run_config(cli.parser().parse_args(argv))
        conf.update(loop_overrides)
        run_dir = os.path.join(tmp, path, "run")
        counts.run(path, lambda: training_loop(run_dir=run_dir, step_fn=step_fn, **conf))
    torch.cuda.empty_cache()
    for name, by_path in counts.by_path.items():
        if by_path[path]:
            raise AssertionError(f"{path} launched {name} {by_path[path]} times")
    if len(rec["ms"]) != steps:
        raise AssertionError(f"{path}: {len(rec['ms'])} steps ran, not {steps}")
    return run_dir, rec


def log_steps(path, rec, card, resident=()):
    """Step 0, steps 1-3 and their median, images/s, peak over the steps
    but those in `resident` (copies of the trainer resident), phase 16's
    numbers beside them."""
    med = statistics.median(rec["ms"][1:4])
    peak = max(m for i, m in enumerate(rec["peak"][:4]) if i not in resident)
    base = TRAIN_RESULTS.get("train")
    vs = ("" if base is None else
          f" (phase train: step 0 {base['ms'][0]:.1f} ms, median {base['median']:.1f} "
          f"ms, peak {max(base['peak'][i] for i in (0, 1, 3)) / 2**30:.2f} GiB)")
    log(f"{path}: step 0 (every phase) {rec['ms'][0]:.1f} ms; steps 1-3 "
        + ", ".join(f"{m:.1f}" for m in rec["ms"][1:4]) + f" ms, median {med:.1f} ms; "
        f"{4 / med * 1e3:.2f} images/s at batch 4 (none profiled); peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB{vs} [{card}]")
    return med


def profiled_phases(path, trainer, inputs, gen_state, kw, card):
    """One extra step with every phase (step_idx 16) on a copy of the
    trainer, under the profiler with host and device activity, after one
    unprofiled warm-up step of the copy (its first step allocates): each
    phase's device span and the step's idle share (host tracing included in
    the wall time)."""
    import copy
    from pix2pix3d_tpu_torch.models.triplane import STAGES
    names, idx = PHASES, 16
    twin = copy.deepcopy(trainer)
    twin.step(*inputs, cuda_generator(gen_state), **dict(kw, step_idx=idx))
    wall, busy, spans, top = profile_step(
        lambda: twin.step(*inputs, cuda_generator(gen_state), **dict(kw, step_idx=idx)),
        [f"phase_{n}" for n in names] + list(STAGES), True)
    del twin
    torch.cuda.empty_cache()
    missing = [n for n in names if f"phase_{n}" not in spans]
    if missing:
        raise AssertionError(f"{path}: no device span for phases {missing}")
    log(f"{path}: a step with every phase "
        f"under the profiler (host and device activity): wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}; device span per phase (ms): "
        + ", ".join(f"{n} {spans[f'phase_{n}']:.1f}" for n in names) + f" [{card}]")
    for key, ms, count in top[:5]:
        log(f"  {ms:8.3f} ms {count:5d}x  {key[:90]}")


def phase_train_aug(device, card, counts, folder, tmp):
    """Phase 17: ADA.  The pipe at p=0 is the identity on the card; the
    pipe and one R1 phase, card against CPU at the small width on the same
    draws; the recipe with `--aug fixed --p 0.2` through the CLI for 4 steps
    (a snapshot each tick: phase sinks reads its files) with one profiled
    extra step; then `--aug ada` for 8 steps in ticks of 4, whose logged
    augment_p must be `ada_update_p` folded over the logged signs."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.ops import precision
    from pix2pix3d_tpu_torch.train.augment import AugmentPipe, ada_update_p
    from pix2pix3d_tpu_torch.train.loss import blur_size_bucket

    aug_kw = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                  brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)
    pipe = AugmentPipe(**aug_kw)
    x = torch.rand((4, 512, 512, 6), generator=torch.Generator().manual_seed(2)
                   ).to(device) * 2 - 1
    with precision.policy(False):
        same = torch.equal(pipe(x, 0.0, torch.Generator(device=device).manual_seed(0)), x)
        moved = (pipe(x, 1.0, torch.Generator(device=device).manual_seed(0)) - x).abs().amax()
    if not same or not moved > 0:
        raise AssertionError(f"the pipe at p=0 is not the identity ({same}) or at p=1 "
                             f"changes nothing ({float(moved)})")
    log(f"train-aug: the pipe (train.py's set) at p=0 returns its [4, 512, 512, 6] "
        f"input bit for bit on the card; at p=1 it moves entries by up to "
        f"{float(moved):.3f}")
    blur = (10.0, blur_size_bucket(10.0))
    card_vs_cpu("train-aug R1 through the pipe (p=1)", device, card,
                lambda dev: small_loss(dev, aug=aug_kw), lambda L: L.D,
                lambda L, b, z, c, g: L.d_r1(b, g, blur, TINY_NRR, aug_p=1.0))

    def after(trainer, inputs, gen_state, kw, stats):
        if kw["step_idx"] == TRAIN_STEPS - 1:
            profiled_phases("train-aug", trainer, inputs, gen_state, kw, card)

    run_dir, rec = run_recipe("train-aug", AUG_FLAGS, folder, tmp, device, card,
                              counts, after=after)
    TRAIN_RESULTS["train-aug"] = dict(rec, run_dir=run_dir)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    if [t["Progress/augment_p"] for t in ticks] != [0.2]:
        raise AssertionError(f"augment_p logged: {[t['Progress/augment_p'] for t in ticks]}")
    log_steps("train-aug", rec, card)

    # --aug ada: the heuristic every 4 steps over the tick's signs
    _, ada = run_recipe("train-ada", ["--aug", "ada", f"--target={ADA_TARGET}"], folder,
                        tmp, device, card, counts,
                        steps=ADA_STEPS, tick_steps=4,
                        loop_overrides=dict(snapshot_ticks=None,
                                            image_snapshot_ticks=None))
    with open(os.path.join(tmp, "train-ada", "run", "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    p, want = 0.0, []
    for tick in ticks:
        p = ada_update_p(p, tick["Loss/signs/real"], 4, ada_interval=4, ada_kimg=500,
                         ada_target=ADA_TARGET)
        want.append(p)
    got = [t["Progress/augment_p"] for t in ticks]
    if len(ticks) != 2 or got != want or not got[-1] > 0:
        raise AssertionError(f"ADA: augment_p logged {got}, folded {want}")
    log(f"train-aug ADA: {ADA_STEPS} steps in ticks of 4; Loss/signs/real "
        + ", ".join(f"{t['Loss/signs/real']:.3f}" for t in ticks)
        + f" -> augment_p {got} = ada_update_p folded over them (target {ADA_TARGET}); "
        "steps "
        + ", ".join(f"{m:.1f}" for m in ada["ms"]) + f" ms [{card}]")
    phase_done("train-aug", t0)


def phase_sinks(card):
    """Phase 18: the run directory of phase 17's CLI run: a TensorBoard
    event file whose every record passes its length and data CRC checks
    (the tick's scalars, the trend and four image grids), and a finite
    feature-distance trend in quality.jsonl (a skipped trend writes none)."""
    t0 = time.time()
    run_dir = TRAIN_RESULTS["train-aug"]["run_dir"]
    events = [n for n in os.listdir(run_dir) if n.startswith("events.out.tfevents.")]
    if len(events) != 1:
        raise AssertionError(f"sinks: event files {events}")
    path = os.path.join(run_dir, events[0])
    records = read_tb_records(path)
    if len(records) != 1 + 1 + 1 + 4:
        raise AssertionError(f"sinks: {len(records)} TensorBoard records, expected 7 "
                             "(header, tick scalars, trend, four grids)")
    quality = os.path.join(run_dir, "quality.jsonl")
    if not os.path.exists(quality):
        raise AssertionError("sinks: no quality.jsonl: the fd trend was skipped")
    with open(quality) as f:
        lines = [json.loads(line) for line in f]
    fd = [q["fd_proxy_real_fake"] for q in lines]
    if len(fd) != 1 or not all(math.isfinite(v) for v in fd):
        raise AssertionError(f"sinks: fd_proxy_real_fake {fd}")
    log(f"sinks: {os.path.getsize(path)} B TensorBoard event file, {len(records)} "
        f"records, every length and data CRC-32C right; quality.jsonl "
        f"fd_proxy_real_fake {fd[0]:.6g} (random-convolution proxy, 4 fakes vs 4 "
        f"reals) [{card}]")
    phase_done("sinks", t0)


def phase_train_frustum(device, card, counts, folder, tmp):
    """Phase 19: `--sampler frustum` (train.py's frustum defaults: 96 slabs
    in chunks of 8, bf16 slabs).  One G main phase, card against CPU at the
    small width with f32 slabs; the recipe for 4 steps with one profiled
    extra step; after step 3 the G main phase's gradients at full width
    (finite, before the trainer's nan_to_num) and its peak memory with
    `frustum_remat` on and off."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.train.loss import blur_size_bucket
    blur = (10.0, blur_size_bucket(10.0))
    small = dict(sampler="frustum", frustum_depth_steps=8, frustum_chunk=4,
                 frustum_bf16=False)
    card_vs_cpu("train-frustum G main (f32 slabs, no cross-view term)", device, card,
                lambda dev: small_loss(dev, rendering=small, lambda_cross_view=0.0),
                lambda L: L.G,
                lambda L, b, z, c, g: L.g_main(b, z, c, g, blur, TINY_NRR), b=1)

    def gmain_peak(trainer, inputs, remat):
        batch, gen_z, gen_c = inputs
        rk = trainer.G.rendering_kwargs
        rk["frustum_remat"] = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            _, grads = phase_grads(trainer.loss, trainer.G, lambda L: L.g_main(
                batch, gen_z[0], gen_c[0], torch.Generator(device=device).manual_seed(4),
                0.0, 128))
            bad = sum(int((~torch.isfinite(g)).sum()) for g in grads.values())
            return torch.cuda.max_memory_allocated(), base, bad
        finally:
            del rk["frustum_remat"]

    def after(trainer, inputs, gen_state, kw, stats):
        if kw["step_idx"] != TRAIN_STEPS - 1:
            return
        peak_on, base, bad = gmain_peak(trainer, inputs, True)
        if bad:
            raise AssertionError(f"train-frustum: {bad} non-finite G gradient entries "
                                 "(bf16 slabs, nrr 128)")
        torch.cuda.empty_cache()
        try:
            peak_off, _, _ = gmain_peak(trainer, inputs, False)
            off = f"{peak_off / 2**30:.2f} GiB"
        except torch.OutOfMemoryError as e:
            off = f"does not fit on the card ({str(e).splitlines()[0][:120]})"
        torch.cuda.empty_cache()
        log(f"train-frustum: the G main phase at full width (bf16 slabs, nrr 128, "
            f"batch 4): every G gradient entry finite; peak max_memory_allocated with "
            f"frustum_remat on {peak_on / 2**30:.2f} GiB, off {off} (the trainer's "
            f"state {base / 2**30:.2f} GiB resident) [{card}]")
        # device activity only: tracing the host costs ~90 s a step on this
        # path (its per-phase spans are in PERF.md)
        idle_share("train-frustum", trainer, inputs, gen_state, kw, card)

    flags = ["--sampler", "frustum"]
    _, rec = run_recipe("train-frustum", flags, folder, tmp, device, card, counts,
                        after=after,
                        loop_overrides=dict(snapshot_ticks=None, image_snapshot_ticks=None))
    log_steps("train-frustum", rec, card)
    log("train-frustum: both kernels' launch counts 0 on this path (the frustum "
        "sampler decodes unfused in training, as in JAX)")
    phase_done("train-frustum", t0)


def phase_train_remat(device, card, counts, folder, tmp):
    """Phase 20: `--remat True` for 4 steps beside phase 16; before step 2
    two copies of the trainer, one with remat and one without, each run
    step 2 from its inputs and generator state under deterministic
    algorithms: equal bit for bit."""
    t0 = time.time()
    import copy
    held = {}

    def after(trainer, inputs, gen_state, kw, stats):
        if kw["step_idx"] == 1:
            # the state step 2 starts from
            held["remat"] = copy.deepcopy(trainer)
            held["plain"] = copy.deepcopy(trainer)
            held["plain"].loss.remat = False
        if kw["step_idx"] != 2:
            return
        twins = (held.pop("remat"), held.pop("plain"))
        if not (twins[0].loss.remat and trainer.loss.remat):
            raise AssertionError("the loss does not remat")
        (s_remat, s_plain), flagged = deterministic_steps(twins, inputs, gen_state, kw)
        diffs = device_state_diff(*twins, optimizers=True)
        unequal = [k for k in s_plain if not np.array_equal(s_plain[k], s_remat[k])]
        if any(diffs.values()) or unequal:
            raise AssertionError(
                "remat step 2 differs from the plain one under deterministic "
                f"algorithms: largest differences {diffs}, stats {unequal}; ops without "
                f"a deterministic version: {flagged}")
        del twins
        torch.cuda.empty_cache()
        log(f"train-remat: step 2 with remat equals step 2 without it bit for bit "
            f"(parameters, buffers, Adam moments and counts, stats), both from the "
            f"same state and generator state under deterministic algorithms; ops "
            f"flagged as without a deterministic version: {flagged or 'none'} [{card}]")

    _, rec = run_recipe("train-remat", ["--remat", "True"], folder, tmp, device, card,
                        counts, after=after,
                        loop_overrides=dict(snapshot_ticks=None, image_snapshot_ticks=None))
    log_steps("train-remat", rec, card, resident=(2,))
    phase_done("train-remat", t0)


def phase_autograd_guard(device, card, counts):
    """Phase 21: each kernel wrapper, called on the card with an input that
    requires grad under grad mode, raises before it launches."""
    t0 = time.time()
    from pix2pix3d_tpu_torch.ops import decode_composite as dc
    from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd
    gen = torch.Generator().manual_seed(6)
    dc_args = kernel_inputs(dc, torch.float32, False, gen, device)
    lsd_args = decode_inputs(600, torch.float32, False, 6, device)
    for name, fn, args in (("decode_composite", dc.fused_decode_composite, dc_args),
                           ("late_separate_decode", lsd.late_separate_decode,
                            lsd_args[:5])):
        leaf = args[0].detach().clone().requires_grad_(True)

        def call():
            try:
                fn(leaf, *args[1:])
            except RuntimeError as e:
                if "has no backward" not in str(e):
                    raise
                return str(e)
            raise AssertionError(f"{name} ran on an input that requires grad")
        msg = counts.run("autograd-guard", call)
        with torch.no_grad():
            fn(leaf, *args[1:])
        torch.cuda.synchronize()
        log(f"autograd guard: {name} on the card refuses an input that requires "
            f"grad ({msg!r}); under torch.no_grad() it runs")
    for name, by_path in counts.by_path.items():
        if by_path["autograd-guard"]:
            raise AssertionError(f"the refused calls launched {name}")
    phase_done("autograd guard", t0)


# ---------------------------------------------------------------------------
# phases 22-27 (every generator of the JAX registries besides the shipped one)

# the recipe with train.py's defaults for --render_mask/--dis_mask
# (TriPlaneGenerator, no D_semantic); the cross-view term needs semantic
# outputs (its renders read them, in both packages), so it is off, as in
# train.py's defaults
EG3D_FLAGS = ["--render_mask", "False", "--dis_mask", "False",
              "--lambda_cross_view", "0"]
BG_FLAGS = ["--use_bg", "True", "--silhouette_loss", "True"]
# the fused decode+composite against the unfused render (f32 slabs): the
# JAX suite's fused-vs-unfused generator tolerance, as phase 6
FUSED_TOL = 5e-3
# dual SR against the separate stacks, f32 with TF32 off: the gate of
# tests/test_dual_sr.py.  As served (bf16 SR blocks), the grouped and the
# dense convolutions round to bf16 in other places; that difference is held
# to the one the bf16 blocks already make against f32 (the separate stacks
# either way), and its share of the file's bf16 gate (2e-2, set for the 2X
# stack on inputs of unit scale) is printed
DUAL_TOL = 1e-5
DUAL_BF16_TOL = 2e-2


def request_inputs(G, seed, device):
    """A batch-1 request: z, a random label map (or edge map, as the apps
    rescale it) at the generator's resolution, phase 4's camera."""
    from pix2pix3d_tpu_torch.apps.common import mask_input
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler,
                                                   fov_to_intrinsics,
                                                   pose_to_conditioning)
    gen = torch.Generator().manual_seed(seed)
    res = G.img_resolution
    z = torch.randn((1, G.z_dim), generator=gen).to(device)
    if G.data_type == "edge":
        raw = (torch.rand((res, res, 1), generator=gen) > 0.9).float() * 255
    else:
        raw = torch.randint(0, getattr(G, "semantic_channels", 6), (res, res, 1),
                            generator=gen).float()
    c2w = LookAtPoseSampler.sample(math.pi / 2, math.pi / 2, [0, 0, -0.06],
                                   radius=2.7, device=device)
    pose = pose_to_conditioning(c2w, fov_to_intrinsics(18.837, device=device))
    return z, pose, {"mask": mask_input(G, raw.numpy(), device), "pose": pose}


def check_shapes(outs, expect):
    for key, shape in expect.items():
        if tuple(outs[key].shape) != shape:
            raise AssertionError(f"{key} {tuple(outs[key].shape)} != {shape}")
        if not torch.isfinite(outs[key]).all():
            raise AssertionError(f"{key} has non-finite values")


def variant_requests(path, G, counts, card, nrr, per_request, n=1, tf32=False,
                     seed=11, **kw):
    """One warm-up and `n` batch-1 requests of `G` on `path` (const noise,
    det, TF32 `tf32`), each request's launches checked; the outputs' shapes
    and finiteness; logs the times and the parameter count.  Returns the
    last outputs and the inputs."""
    from pix2pix3d_tpu_torch.ops import precision
    z, pose, batch = request_inputs(G, seed, next(G.parameters()).device)

    def request():
        with torch.no_grad(), precision.policy(tf32):
            return G(z, pose, batch, neural_rendering_resolution=nrr,
                     noise_mode="const", det=True, **kw)

    request()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = counts.requests(path, request, n, per_request)
    res, sem = G.img_resolution, getattr(G, "semantic_channels", None)
    expect = {"image": (1, res, res, 3), "image_raw": (1, nrr, nrr, 3),
              "image_depth": (1, nrr, nrr, 1)}
    if "semantic" in outs:
        expect.update(semantic=(1, res, res, sem), semantic_raw=(1, nrr, nrr, sem))
    if "weight" in outs:
        expect["weight"] = (1, nrr, nrr, 1)
    check_shapes(outs, expect)
    log(f"{path}: {type(G).__name__} ({type(G.backbone.mapping).__name__}, "
        f"{type(G.superresolution).__name__}), "
        f"{sum(p.numel() for p in G.parameters()) / 1e6:.1f} M params; {n} request(s) "
        f"at batch 1, nrr {nrr}: ms {[round(t, 3) for t in times]}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; outputs "
        + ", ".join(f"{k} {v}" for k, v in expect.items())
        + f" finite; launches decode_composite "
        f"{counts.by_path['decode_composite'][path]}, late_separate_decode "
        f"{counts.by_path['late_separate_decode'][path]} [{card}]")
    return outs, (z, pose, batch)


def idle_share(path, trainer, inputs, gen_state, kw, card):
    """After the run's last step (the trainer warm), one more step without
    the reg phases under the profiler, device activity only: the idle
    share."""
    from pix2pix3d_tpu_torch.models.triplane import STAGES
    kw = dict(kw, step_idx=5)
    wall, busy, _, top = profile_step(
        lambda: trainer.step(*inputs, cuda_generator(gen_state), **kw),
        [f"phase_{n}" for n in PHASES_NO_REG] + list(STAGES), False)
    log(f"{path}: a step with no reg phases under the profiler (device "
        f"activity): wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f} [{card}]")
    for key, ms, count in top[:3]:
        log(f"  {ms:8.3f} ms {count:5d}x  {key[:90]}")


def idle_share_after(path, card):
    """An `after` hook for run_recipe: `idle_share` after the last step."""
    def after(trainer, inputs, gen_state, kw, stats):
        if kw["step_idx"] == TRAIN_STEPS - 1:
            idle_share(path, trainer, inputs, gen_state, kw, card)
    return after


def phase_eg3d(device, card, counts, folder, tmp):
    """Phase 22: conditional EG3D (`TriPlaneGenerator`, train.py's
    `--render_mask False`) at full width: a request on each sampler, the
    fused decoder refused, then the recipe with train.py's defaults for
    --render_mask/--dis_mask for 4 steps."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator

    cfg = config.generator_config(cfg="afhq", resolution=512, render_mask=False,
                                  semantic_channels=6, gen_pose_cond=True)
    G = build_generator(device=device, seed=0, **cfg)
    variant_requests("eg3d-cond", G, counts, card, APP_NRR, NO_LAUNCHES)
    frustum = {k: v for k, v in config.SERVING_RENDERING.items() if k != "decoder_impl"}
    G.rendering_kwargs.update(frustum)
    variant_requests("eg3d-cond-frustum", G, counts, card, APP_NRR, NO_LAUNCHES,
                     tf32=True)
    G.rendering_kwargs["decoder_impl"] = "kernel"
    z, pose, batch = request_inputs(G, 11, device)
    try:
        with torch.no_grad():
            G(z, pose, batch, neural_rendering_resolution=APP_NRR, noise_mode="const")
    except ValueError as e:
        if "OSGDecoderSemanticLateSeparate" not in str(e):
            raise
        log(f"eg3d-cond: decoder_impl='kernel' refused: {str(e)[:100]}...")
    else:
        raise AssertionError("TriPlaneGenerator ran the fused decoder")
    del G
    torch.cuda.empty_cache()
    _, rec = run_recipe("train-eg3d", EG3D_FLAGS, folder, tmp, device, card, counts,
                        after=idle_share_after("train-eg3d", card),
                        loop_overrides=dict(snapshot_ticks=None, image_snapshot_ticks=None))
    log_steps("train-eg3d", rec, card)
    phase_done("eg3d-cond", t0)


def phase_seg2cat_bg(device, card, counts, folder, tmp):
    """Phase 23: the background generator (`--use_bg True`) at full seg2cat
    width.  Requests under the serving keys (decode_composite once each),
    the fused render against the unfused one, the importance render through
    the decoder kernel against impl="ref", each kernel against its plain
    version on this path's inputs; then the recipe with `--use_bg True
    --silhouette_loss True` for 4 steps."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.ops import decode_composite as dc
    from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd
    from pix2pix3d_tpu_torch.ops import precision
    from pix2pix3d_tpu_torch.render.ray_sampler import sample_rays

    cfg = config.serving_generator_config("seg2cat", use_bg=True)
    G = build_generator(device=device, seed=0, **cfg)
    kernel, dkernel = dc.fused_decode_composite, lsd.late_separate_decode
    captured = []

    def recording(*a, **kw):
        if not captured:
            captured.append((a, kw))
        return kernel(*a, **kw)

    dc.fused_decode_composite = recording
    try:
        outs, (z, pose, batch) = variant_requests(
            "seg2cat-bg", G, counts, card, config.SERVING_NEURAL_RENDERING_RESOLUTION,
            ONE_DECODE_COMPOSITE, n=2, tf32=True)
    finally:
        dc.fused_decode_composite = kernel
    w = outs["weight"]
    log(f"seg2cat-bg: weight image in [{float(w.min()):.4f}, {float(w.max()):.4f}]")

    # the fused render against the unfused one, all f32, TF32 off
    rk = G.rendering_kwargs
    serving = dict(rk)
    rk.update(frustum_bf16=False, sr_sem_precision=None)
    out_f32 = {}
    with torch.no_grad(), precision.policy(False):
        ws = G.mapping(z, pose, batch)
        for impl in ("kernel", None):
            rk["decoder_impl"] = impl
            out_f32[impl] = G.synthesis(ws, pose, neural_rendering_resolution=APP_NRR,
                                        noise_mode="const", force_fp32=True)
    rk.clear()
    rk.update(serving)
    for key in ("image", "image_raw", "image_depth", "semantic", "semantic_raw",
                "weight"):
        abs_e, rel_e, used, _ = compare((out_f32["kernel"][key],),
                                        (out_f32[None][key],), FUSED_TOL)
        log(f"seg2cat-bg unfused vs kernel (f32) {key:12s}: max abs {abs_e:.3e} rel "
            f"{rel_e:.3e} ({used:.3f} of tol {FUSED_TOL})")
    del out_f32

    # decode_composite against its plain version on this path's inputs
    a, kw = captured[0]
    tol, rms_tol = TOL[a[0].dtype]
    with torch.no_grad(), precision.policy(False):
        got = kernel(*a, **kw)
        torch.cuda.synchronize()
        want = dc.decode_composite_plain(*a, **kw)
        abs_e, _, used, rms = compare(got, want, tol, rms_tol)
    log(f"seg2cat-bg decode_composite vs plain on the path's inputs (feats "
        f"{tuple(a[0].shape)} {a[0].dtype}, {kw}): max abs {abs_e:.3e} ({used:.3f} of "
        f"tol {tol}), RMS {rms:.3e} (tol {rms_tol}) [{card}]")
    del captured, got, want, a

    # the importance renderer through the decoder kernel
    planes = outs["planes"]
    rk_imp = config.preset_generator_config("seg2cat")["rendering_kwargs"]
    ray_o, ray_d = sample_rays(pose[:, :16].reshape(-1, 4, 4),
                               pose[:, 16:].reshape(-1, 3, 3), APP_NRR)
    chunk = rk_imp.get("point_chunk", 65536)
    expected = sum(math.ceil(APP_NRR ** 2 * rk_imp[k] / chunk)
                   for k in ("depth_resolution", "depth_resolution_importance"))
    dcaptured = []

    def drecording(*a, **kw):
        if not dcaptured:
            dcaptured.append((a, kw))
        return dkernel(*a, **kw)

    def render(impl):
        return G.renderer(planes, lambda f, d: G.decoder(f, d, impl=impl),
                          ray_o, ray_d, rk_imp, det=True)

    with torch.no_grad(), precision.policy(False):
        lsd.late_separate_decode = drecording
        try:
            got = counts.run("seg2cat-bg-importance-kernel", lambda: render("kernel"))
        finally:
            lsd.late_separate_decode = dkernel
        want = render("ref")
    launched = {n: c["seg2cat-bg-importance-kernel"] for n, c in counts.by_path.items()}
    if launched != {"decode_composite": 0, "late_separate_decode": expected}:
        raise AssertionError(f"seg2cat-bg importance render launched {launched}, "
                             f"expected {expected} late_separate_decode")
    for name, g_, w_ in zip(("features", "depth", "weight sum"), got, want):
        abs_e, rel_e, used, _ = compare((g_,), (w_,), RENDER_TOL)
        log(f"seg2cat-bg importance render, kernel vs ref decoder {name:10s}: max abs "
            f"{abs_e:.3e} rel {rel_e:.3e} ({used:.3f} of tol {RENDER_TOL})")
    a, kw = dcaptured[0]
    with torch.no_grad(), precision.policy(False):
        got = dkernel(*a, **kw)
        torch.cuda.synchronize()
        want = lsd.late_separate_decode_plain(*a, **kw)
        d_abs, used, rms_c, rms_s = compare_decode(got, want, kw["compute_dtype"])
    log(f"seg2cat-bg late_separate_decode vs plain on the path's chunk (feats "
        f"{tuple(a[0].shape)} {a[0].dtype}): max abs {d_abs:.3e} ({used:.3f} of tol), "
        f"RMS colors {rms_c:.3e} sigma {rms_s:.3e}; {launched['late_separate_decode']} "
        f"launches in the render [{card}]")
    del dcaptured, got, want, a, planes, outs

    # the same generator on the importance sampler (impl="ref", no kernel)
    for k in config.SERVING_RENDERING:
        rk.pop(k, None)
    variant_requests("seg2cat-bg-importance", G, counts, card, APP_NRR, NO_LAUNCHES)
    del G
    torch.cuda.empty_cache()
    _, rec = run_recipe("train-bg", BG_FLAGS, folder, tmp, device, card, counts,
                        after=idle_share_after("train-bg", card),
                        loop_overrides=dict(snapshot_ticks=None, image_snapshot_ticks=None))
    log_steps("train-bg", rec, card)
    phase_done("seg2cat-bg", t0)


def phase_other_generators(device, card, counts):
    """Phases 24-26: one request each of seg2face at 256² (the 4X SR pair),
    the two-backbone generator at seg2cat width, and the entangled mappings
    (seg2cat with MaskMappingNetwork, edge2car with EdgeMappingNetwork), all
    full width, importance sampler, f32 with TF32 off."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator

    cases = [("seg2face-256", config.preset_generator_config("seg2face", resolution=256),
              APP_NRR)]
    two = config.preset_generator_config("seg2cat")
    two["class_name"] = "TriPlaneSemanticGenerator"
    cases.append(("two-backbone", two, APP_NRR))
    for name, preset, mapping, nrr in (("entangled-seg2cat", "seg2cat",
                                        "MaskMappingNetwork", APP_NRR),
                                       ("entangled-edge2car", "edge2car",
                                        "EdgeMappingNetwork", 64)):
        cfg = config.preset_generator_config(preset)
        cfg["mapping_kwargs"]["class_name"] = mapping
        cases.append((name, cfg, nrr))
    for name, cfg, nrr in cases:
        t1 = time.time()
        G = build_generator(device=device, seed=0, **cfg)
        variant_requests(name, G, counts, card, nrr, NO_LAUNCHES)
        del G
        torch.cuda.empty_cache()
        log(f"{name}: built and served in {time.time() - t1:.1f} s")
    phase_done("other generators", t0)


def phase_dual_sr(device, card, counts):
    """Phase 27: the serving generator with `rendering_kwargs['dual_sr']`
    against the separate SR stacks (sr_sem_precision dropped: it takes
    priority over dual_sr), as served (bf16 blocks, TF32) and all f32 with
    TF32 off; the request times of both."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.ops import precision

    cfg = config.serving_generator_config("seg2cat")
    cfg["rendering_kwargs"].pop("sr_sem_precision")
    G = build_generator(device=device, seed=0, **cfg)
    z, pose, batch = request_inputs(G, 12, device)
    nrr = config.SERVING_NEURAL_RENDERING_RESOLUTION
    with torch.no_grad(), precision.policy(True):
        ws = G.mapping(z, pose, batch)
        planes = G.synthesis(ws, pose, neural_rendering_resolution=nrr,
                             noise_mode="const")["planes"]
    rk = G.rendering_kwargs
    results = {}
    for label, tf32, fp32 in (("bf16", True, False), ("f32", False, True)):
        for dual in (False, True, False, True):
            rk["dual_sr"] = dual

            def request():
                with torch.no_grad(), precision.policy(tf32):
                    return G.synthesis(ws, pose, neural_rendering_resolution=nrr,
                                       noise_mode="const", force_fp32=fp32,
                                       planes=planes)
            times, out = counts.run("dual-sr", lambda: timed_requests(request, 1))
            results.setdefault((label, dual), []).append(times[0])
            results[(label, dual, "out")] = out
        log(f"dual-sr ({label}): synthesis from cached planes, ms separate "
            f"{[round(t, 3) for t in results[(label, False)]]}, dual "
            f"{[round(t, 3) for t in results[(label, True)]]} [{card}]")
    for key in ("image", "semantic"):
        def out(label, dual):
            return results[(label, dual, "out")][key].float()
        abs_e, rel_e, used, _ = compare((out("f32", True),), (out("f32", False),),
                                        DUAL_TOL)
        log(f"dual-sr (f32) {key:8s}: dual vs separate max abs {abs_e:.3e} rel "
            f"{rel_e:.3e} ({used:.3f} of tol {DUAL_TOL})")
        err = (out("bf16", True) - out("bf16", False)).abs()
        rounding = float((out("bf16", False) - out("f32", False)).abs().max())
        share = float((err / (DUAL_BF16_TOL * (1 + out("bf16", False).abs()))).max())
        if not float(err.max()) <= rounding:
            raise AssertionError(f"dual-sr (bf16) {key}: dual vs separate "
                                 f"{float(err.max()):.3e} > the bf16 blocks' own "
                                 f"rounding {rounding:.3e}")
        log(f"dual-sr (bf16) {key:8s}: dual vs separate max abs {float(err.max()):.3e} "
            f"(the bf16 blocks against f32: {rounding:.3e}; {share:.3f} of "
            f"tests/test_dual_sr.py's bf16 allclose at {DUAL_BF16_TOL}; largest "
            f"|output| {float(out('bf16', False).abs().max()):.3f})")
    for name, by_path in counts.by_path.items():
        want = 8 if name == "decode_composite" else 0
        if by_path["dual-sr"] != want:
            raise AssertionError(f"dual-sr launched {name} {by_path['dual-sr']} times")
    del G
    torch.cuda.empty_cache()
    phase_done("dual-sr", t0)


# ---------------------------------------------------------------------------
# phase 28 (the metrics package through the serving generator)

# the metrics' batch (compute_miou, iterate_gen_features)
METRIC_BATCH = 8
# the small counts of the metrics whose registered sizes (fid2k: 2000
# generated images) do not fit this script's time
METRIC_REAL, METRIC_GEN, METRIC_IS, METRIC_PPL, PPL_BATCH = 16, 64, 16, 16, 4
# the fused render against decoder_impl=None on one metric batch, as served
# (bf16 slabs, TF32): the share of pixels whose argmax semantic labels agree
ARGMAX_AGREE = 0.99


def numbers(value):
    """The numbers in a metric's result (nested dicts, tuples, floats)."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in numbers(v)]
    return [value] if isinstance(value, (int, float)) else []


def phase_metrics(device, card, counts, folder, tmp, sfu_per_s, request_ms):
    """Phase 28: the metrics package through the full-width serving
    generator at batch 8 (nrr 128): `calc_metric("miou500")` in full, FID,
    KID and PR on the random-convolution proxy and FID and IS on the port's
    Inception (random weights in a temporary npz named by
    PIX2PIX3D_INCEPTION_NPZ) at small counts, PPL; generation and feature
    time split with `utils.profiling.PhaseTimer`; decode_composite's
    launches (one per generator forward) and its N=8 inputs against its
    plain version; the fused render against decoder_impl=None."""
    t0 = time.time()
    from pix2pix3d_tpu_torch import config
    from pix2pix3d_tpu_torch.metrics import (frechet_inception_distance, inception,
                                             inception_score, kernel_inception_distance,
                                             metric_main, metric_utils,
                                             perceptual_path_length, precision_recall)
    from pix2pix3d_tpu_torch.models import build_generator
    from pix2pix3d_tpu_torch.ops import decode_composite as dc
    from pix2pix3d_tpu_torch.ops import precision
    from pix2pix3d_tpu_torch.train.dataset import build_dataset
    from pix2pix3d_tpu_torch.utils.profiling import PhaseTimer

    cfg = config.serving_generator_config("seg2cat")
    G = build_generator(device=device, seed=0, **cfg)
    # the metrics call G without a rendering resolution: serve at 128²
    G.neural_rendering_resolution = config.SERVING_NEURAL_RENDERING_RESOLUTION
    ds = build_dataset(*folder, "seg", use_labels=True)
    timer = PhaseTimer()
    calls = {"forward": 0, "synthesis": 0}

    class Timed:
        """G with its forwards and syntheses timed and counted."""

        def __getattr__(self, name):
            return getattr(G, name)

        def __call__(self, *a, **kw):
            calls["forward"] += 1
            with timer.tick("generate", block_on=device):
                return G(*a, **kw)

        def synthesis(self, *a, **kw):
            calls["synthesis"] += 1
            with timer.tick("generate", block_on=device):
                return G.synthesis(*a, **kw)

    class TimedDetector:
        def __init__(self, det):
            self.det = det

        def __call__(self, images):
            with timer.tick("features", block_on=device):
                return self.det(images)

        def __getattr__(self, name):     # logits, where the detector has them
            fn = getattr(self.det, name)

            def timed(*a):
                with timer.tick("features", block_on=device):
                    return fn(*a)
            return timed

    extractor = metric_utils.get_feature_extractor
    metric_utils.get_feature_extractor = lambda dev: TimedDetector(extractor(dev))
    kernel = dc.fused_decode_composite
    captured = []

    def recording(*a, **kw):
        if not captured:
            captured.append((a, kw))
        return kernel(*a, **kw)

    def run(label, fn):
        """`fn()` on the metrics path (TF32 as served), its launches counted;
        logs its value, seconds, generate/features split, forwards."""
        timer.totals.clear()
        timer.counts.clear()
        before = dict(calls)
        t1 = time.perf_counter()
        with torch.no_grad(), precision.policy(True):
            value = counts.run("metrics", fn)
        secs = time.perf_counter() - t1
        if not all(math.isfinite(x) for x in numbers(value)):
            raise AssertionError(f"metrics {label}: {value} is not finite")
        split = ", ".join(f"{k} {timer.totals[k]:.3f} s in {timer.counts[k]} calls"
                          for k in timer.totals)
        log(f"metrics {label}: {value} in {secs:.2f} s ({split}; generator "
            f"forwards {calls['forward'] - before['forward']}, syntheses "
            f"{calls['synthesis'] - before['synthesis']}) [{card}]")
        return value

    npz = os.path.join(tmp, "inception_v3.npz")
    dc.fused_decode_composite = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        res = run("miou500", lambda: metric_main.calc_metric(
            "miou500", G=Timed(), dataset=ds, device=device))
        peak = torch.cuda.max_memory_allocated()
        n_img = calls["forward"] * METRIC_BATCH
        gen_ms = 1e3 * timer.totals["generate"] / n_img
        log(f"metrics miou500: miou {res['results']['miou']:.6f}, pixel_acc "
            f"{res['results']['pixel_acc']:.6f}, total_time {res['total_time']:.2f} s; "
            f"{calls['forward']} forwards at batch {METRIC_BATCH}: "
            f"{1e3 * res['total_time'] / n_img:.2f} ms per image in all, "
            f"{gen_ms:.2f} ms per image in the generator (batch-1 request "
            f"{request_ms:.3f} ms, 8x {8 * request_ms:.1f} ms against "
            f"{METRIC_BATCH * gen_ms:.1f} ms a batch-8 forward); peak "
            f"{peak / 2**30:.2f} GiB [{card}]")
        opts = dict(G=Timed(), dataset=ds, device=device)
        for label, fn in (("fid", frechet_inception_distance.compute_fid),
                          ("kid", kernel_inception_distance.compute_kid),
                          ("pr", precision_recall.compute_pr)):
            run(f"{label} (proxy, max_real {METRIC_REAL}, num_gen {METRIC_GEN})",
                lambda: fn(metric_utils.MetricOptions(**opts), max_real=METRIC_REAL,
                           num_gen=METRIC_GEN))
        np.savez(npz, **inception.random_inception_weights(0))
        os.environ["PIX2PIX3D_INCEPTION_NPZ"] = npz
        if not isinstance(metric_utils.get_feature_extractor(device).det,
                          inception.InceptionV3Features):
            raise AssertionError("PIX2PIX3D_INCEPTION_NPZ set, no Inception loaded")
        run(f"fid (Inception, random weights, max_real {METRIC_REAL}, num_gen "
            f"{METRIC_GEN})", lambda: frechet_inception_distance.compute_fid(
                metric_utils.MetricOptions(**opts), max_real=METRIC_REAL,
                num_gen=METRIC_GEN))
        run(f"is (Inception, random weights, num_gen {METRIC_IS})",
            lambda: inception_score.compute_is(metric_utils.MetricOptions(**opts),
                                               num_gen=METRIC_IS))
        run(f"ppl (num_samples {METRIC_PPL}, batch {PPL_BATCH})",
            lambda: perceptual_path_length.compute_ppl(
                metric_utils.MetricOptions(**opts), num_samples=METRIC_PPL,
                batch_size=PPL_BATCH))
    finally:
        dc.fused_decode_composite = kernel
        metric_utils.get_feature_extractor = extractor
        os.environ.pop("PIX2PIX3D_INCEPTION_NPZ", None)
    launches = counts.by_path["decode_composite"]["metrics"]
    forwards = calls["forward"] + calls["synthesis"]
    if launches != forwards or counts.by_path["late_separate_decode"]["metrics"]:
        raise AssertionError(f"metrics: decode_composite launched {launches} times in "
                             f"{forwards} generator forwards (one each expected), "
                             "late_separate_decode "
                             f"{counts.by_path['late_separate_decode']['metrics']}")
    log(f"metrics: decode_composite launches {launches} = generator forwards "
        f"{calls['forward']} + PPL syntheses {calls['synthesis']}")

    # decode_composite against its plain version on a batch-8 call's inputs
    a, kw = captured[0]
    args = tuple(a)
    if args[0].shape[1] != METRIC_BATCH:
        raise AssertionError(f"captured feats {tuple(args[0].shape)}: N != {METRIC_BATCH}")
    check_block_diagonal(args[5], transposed=True)
    tol, rms_tol = TOL[args[0].dtype]
    with torch.no_grad(), precision.policy(False):
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = dc.decode_composite_plain(*args, **kw)
        max_abs, _, used, rms = compare(got, want, tol, rms_tol)
        kc_ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        targs = kernel_typed(args)
        k_ms = device_ms(lambda: kernel(*targs, **kw), 10)
        pc_ms = cuda_ms(lambda: dc.decode_composite_plain(*args, **kw), 3)
        p_ms = device_ms(lambda: dc.decode_composite_plain(*args, **kw), 3)
        libc_ms, lib_ms = library_ms(args, 10)
    b_ms, b_by, terms = bound(args, kw["sem_sigmoid"], sfu_per_s)
    log(f"metrics decode_composite at N={METRIC_BATCH}: feats {tuple(args[0].shape)} "
        f"{args[0].dtype}, {kw}: max abs {max_abs:.3e} ({used:.3f} of tol {tol}), RMS "
        f"{rms:.3e} (tol {rms_tol}); device ms: kernel {k_ms:.4f}, plain {p_ms:.4f}, "
        f"torch.matmul {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); call ms: kernel "
        f"{kc_ms:.4f}, plain {pc_ms:.4f}, torch.matmul {libc_ms:.4f} [{card}]")
    del captured, args, targs, got, want

    # one metric batch's forward under the profiler: busy, idle share, stages
    from pix2pix3d_tpu_torch.models.triplane import STAGES
    opts = metric_utils.MetricOptions(G=G, dataset=ds, device=device)
    z, mask, pose = metric_utils.sample_inputs(opts, *metric_utils.seeded(opts),
                                               METRIC_BATCH)

    def forward():
        with torch.no_grad(), precision.policy(True):
            return G(z, pose, {"mask": mask, "pose": pose}, noise_mode="const", det=True)
    log(f"metrics: one batch-{METRIC_BATCH} forward under the profiler [{card}]")
    profile_request(forward, STAGES)

    # the fused render against decoder_impl=None on that batch, as served
    rk = G.rendering_kwargs
    sems = {}
    with torch.no_grad(), precision.policy(True):
        ws = G.mapping(z, pose, {"mask": mask, "pose": pose})
        for impl in ("kernel", None):
            rk["decoder_impl"] = impl
            sems[impl] = G.synthesis(ws, pose, noise_mode="const", det=True)["semantic"]
    rk["decoder_impl"] = "kernel"
    fused, plain = sems["kernel"].float(), sems[None].float()
    agree = float((fused.argmax(-1) == plain.argmax(-1)).float().mean())
    top2 = plain.topk(2, dim=-1).values
    err = float((fused - plain).abs().max())
    near = float(((top2[..., 0] - top2[..., 1]) <= err).float().mean())
    log(f"metrics fused vs decoder_impl=None (as served, batch {METRIC_BATCH}): argmax "
        f"agreement {agree:.6f} (floor {ARGMAX_AGREE}); semantic logits max abs "
        f"{err:.3e} of largest {float(plain.abs().max()):.3f}; share of pixels whose "
        f"top two unfused logits are within that {near:.6f} [{card}]")
    if agree < ARGMAX_AGREE:
        raise AssertionError(f"fused vs unfused argmax agreement {agree:.6f} < "
                             f"{ARGMAX_AGREE}")
    del G, sems, fused, plain
    torch.cuda.empty_cache()
    phase_done("metrics", t0)


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
    from pix2pix3d_tpu_torch.ops import cuda_build
    from pix2pix3d_tpu_torch.ops import decode_composite as dc
    from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd
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
    card = smi("name,power.limit")
    print(card, flush=True)
    phase_done("device", t0)

    # ---- 2. build
    t0 = time.time()
    cufilt = os.path.join(os.path.dirname(cuda_build._nvcc()), "cu++filt")

    def build_log(name, out):
        for fn, regs, st, ld in ptxas_report(out, cufilt):
            log(f"ptxas {name}: {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")

    for so in cuda_build.build(dc.NAME, lsd.NAME, log=build_log):
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
                    targs = kernel_typed(args)
                    kd_ms = device_ms(lambda: dc.fused_decode_composite(*targs, **kw), 5)
                    p_ms = cuda_ms(lambda: dc.decode_composite_plain(*args, **kw), 3)
                    log(f"kernel vs plain {str(dtype)[6:]:8s} carry_f32={carry_f32!s:5s} "
                        f"sem_sigmoid={sem_sigmoid!s:5s}: max abs {abs_e:.3e} rel {rel_e:.3e} "
                        f"({used:.3f} of tol {tol}), RMS {rms:.3e} (tol {rms_tol}); "
                        f"kernel device {kd_ms:.4f} ms (call {k_ms:.4f}), plain call "
                        f"{p_ms:.3f} ms")
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
    kernel, dkernel = dc.fused_decode_composite, lsd.late_separate_decode
    counts = PathCounts({"decode_composite": kernel,
                         "late_separate_decode": dkernel})
    times, outs = counts.requests("serve", request, 3, ONE_DECODE_COMPOSITE)
    launches = counts.by_path["decode_composite"]["serve"]
    peak = torch.cuda.max_memory_allocated()
    expect = check_outputs(outs, res, nrr, G.semantic_channels)
    request_ms = statistics.median(times)
    log(f"serve: 3 requests, kernel launches {launches}; per-request ms "
        f"{[round(t, 3) for t in times]} median {request_ms:.3f}; peak memory "
        f"{peak / 2**20:.1f} MiB")

    # noise_mode="random" (the generator's default) on the card: the noise
    # strengths are 0 at init, so set them, then equally seeded generators
    # must give equal outputs and const noise another
    strengths = [p for name, p in G.named_parameters()
                 if name.endswith("noise_strength")]
    for p in strengths:
        p.fill_(0.1)

    def request_random(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad(), precision.policy(True):
            return G(z, pose, batch, neural_rendering_resolution=nrr,
                     generator=gen)

    out_a, out_b = request_random(7), request_random(7)
    const_img = request()["image"]
    for p in strengths:
        p.zero_()
    if not all(torch.equal(out_a[k], out_b[k]) for k in expect):
        raise AssertionError("noise_mode='random': equally seeded requests differ")
    if torch.equal(out_a["image"], const_img):
        raise AssertionError("noise_mode='random' gave the const-noise image")
    check_outputs(out_a, res, nrr, G.semantic_channels)
    log(f"serve: noise_mode='random' from seeded card generators: equal seeds "
        f"agree, max abs difference from const noise "
        f"{(out_a['image'] - const_img).abs().max().item():.3e}")
    del out_a, out_b, const_img
    phase_done("serve", t0)

    # ---- 5. one request under the profiler; keeps the kernel's inputs
    t0 = time.time()
    captured = []

    def recording(*a, **kw):
        captured.append((a, kw))
        return kernel(*a, **kw)

    dc.fused_decode_composite = recording
    try:
        profile_request(request, STAGES)
    finally:
        dc.fused_decode_composite = kernel
    if len(captured) != 1:
        raise AssertionError(f"the request called the kernel wrapper "
                             f"{len(captured)} times, expected 1")
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
    check_block_diagonal(args[5], transposed=True)
    tol, rms_tol = TOL[args[0].dtype]
    with precision.policy(False):
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = dc.decode_composite_plain(*args, **kw)
        max_abs, max_rel, used, rms = compare(got, want, tol, rms_tol)
        kc_ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        targs = kernel_typed(args)
        k_ms = device_ms(lambda: kernel(*targs, **kw), 10)
        pc_ms = cuda_ms(lambda: dc.decode_composite_plain(*args, **kw), 5)
        p_ms = device_ms(lambda: dc.decode_composite_plain(*args, **kw), 5)
        libc_ms, lib_ms = library_ms(args, 10)
    b_ms, b_by, terms = bound(args, kw["sem_sigmoid"], sfu_per_s)
    log(f"main-path kernel inputs: feats {tuple(args[0].shape)} {args[0].dtype}, "
        f"{kw}; bound terms: " + ", ".join(
            f"{k} {n:.4g} -> {ms:.4f} ms" for k, (n, ms) in terms.items()))
    log(f"main-path kernel: max abs {max_abs:.3e} rel {max_rel:.3e} ({used:.3f} "
        f"of tol {tol}), RMS {rms:.3e} (tol {rms_tol}); "
        f"device ms: kernel {k_ms:.4f}, plain {p_ms:.4f}, torch.matmul {lib_ms:.4f}, "
        f"bound {b_ms:.4f} ({b_by}); call ms (CUDA events around one call, host "
        f"launch included): kernel {kc_ms:.4f}, plain {pc_ms:.4f}, torch.matmul "
        f"{libc_ms:.4f}")
    log(f"main-path kernel {achieved(terms, k_ms, sm_clock_mhz * 1e6, n_sm)}")
    phase_done("main-path kernel", t0)
    report = [{
        "name": "decode_composite", "route": "cuda",
        "source": "pix2pix3d_tpu_torch/csrc/decode_composite.cu",
        "replaces": "pix2pix3d_tpu/ops/render_pallas.py:231",
        "launches": launches, "max_abs_err": max_abs, "ms": kc_ms,
        "plain_ms": pc_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": libc_ms, "device_ms": k_ms, "plain_device_ms": p_ms,
        "library_device_ms": lib_ms}]
    del G, outs, out_f32, captured, args, targs, got, want
    torch.cuda.empty_cache()

    # ---- 8. late_separate_decode vs plain on seeded random inputs
    t0 = time.time()
    with torch.no_grad(), precision.policy(False):
        for rows in DECODE_ROWS:
            reps = (3, 2) if rows > 10**6 else (10, 5)
            for dtype in (torch.float32, torch.bfloat16):
                for rgb_sigmoid in (True, False):
                    for sem_sigmoid in (False, True):
                        args = decode_inputs(rows, dtype, sem_sigmoid, rows + 7, device)
                        kw = dict(rgb_sigmoid=rgb_sigmoid, sem_sigmoid=sem_sigmoid,
                                  compute_dtype=dtype)
                        got = dkernel(*args, **kw)
                        torch.cuda.synchronize()
                        want = lsd.late_separate_decode_plain(*args, **kw)
                        abs_e, used, rms_c, rms_s = compare_decode(got, want, dtype)
                        del got, want
                        k_ms = cuda_ms(lambda: dkernel(*args, **kw), reps[0])
                        targs = decode_typed(args, dtype)
                        kd_ms = device_ms(lambda: dkernel(*targs, **kw), reps[0])
                        del targs
                        p_ms = cuda_ms(lambda: lsd.late_separate_decode_plain(
                            *args, **kw), reps[1])
                        b_ms, b_by, terms = bound_decode(args, kw, sfu_per_s)
                        log(f"decoder kernel vs plain M={rows} {str(dtype)[6:]:8s} "
                            f"rgb_sigmoid={rgb_sigmoid!s:5s} sem_sigmoid="
                            f"{sem_sigmoid!s:5s}: max abs {abs_e:.3e} ({used:.3f} "
                            f"of tol {DECODE_TOL[dtype][0]}), RMS colors {rms_c:.3e} "
                            f"sigma {rms_s:.3e} (tol {DECODE_TOL[dtype][1]}); "
                            f"kernel device {kd_ms:.4f} ms (call {k_ms:.4f}), plain "
                            f"call {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                            f"({max(terms, key=lambda k: terms[k][1])}); "
                            + achieved(terms, kd_ms, sm_clock_mhz * 1e6, n_sm))
                        del args
            torch.cuda.empty_cache()
        # a contiguous view one element into its storage, off the words the
        # kernel reads rows in: the wrapper must still give the plain result
        for dtype in (torch.float32, torch.bfloat16):
            args = decode_inputs(DECODE_ROWS[-1], dtype, False, 11, device)
            view = torch.empty(args[0].numel() + 1, dtype=dtype, device=device)[1:]
            view = view.view(args[0].shape)
            view.copy_(args[0])
            got = dkernel(view, *args[1:], compute_dtype=dtype)
            torch.cuda.synchronize()
            want = lsd.late_separate_decode_plain(*args, compute_dtype=dtype)
            abs_e, used, rms_c, rms_s = compare_decode(got, want, dtype)
            log(f"decoder kernel on a view at byte offset {view.data_ptr() % 16} "
                f"mod 16, M={DECODE_ROWS[-1]} {str(dtype)[6:]}: max abs {abs_e:.3e} "
                f"({used:.3f} of tol {DECODE_TOL[dtype][0]}), RMS colors "
                f"{rms_c:.3e} sigma {rms_s:.3e}")
            del args, view, got, want
    phase_done("decoder kernel", t0)

    # ---- 9. the apps' seg2cat generator: importance renderer, full width
    t0 = time.time()
    cfg = config.preset_generator_config("seg2cat")
    if "sampler" in cfg["rendering_kwargs"]:
        raise AssertionError("the apps' preset names a sampler")
    G = build_generator(device=device, seed=0, **cfg)
    res = cfg["img_resolution"]
    log(f"built seg2cat generator, importance renderer "
        f"({sum(p.numel() for p in G.parameters()) / 1e6:.1f} M params) in "
        f"{time.time() - t0:.1f} s")

    def request_importance():
        with torch.no_grad(), precision.policy(False):
            return G(z, pose, batch, neural_rendering_resolution=APP_NRR,
                     noise_mode="const", det=True)

    request_importance()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the generator decodes with impl="ref": neither kernel may launch
    times, outs = counts.requests("serve-importance", request_importance, 3,
                                  NO_LAUNCHES)
    peak_imp = torch.cuda.max_memory_allocated()
    check_outputs(outs, res, APP_NRR, G.semantic_channels)
    log(f"serve-importance: 3 requests; shapes " + ", ".join(
        f"{k} {tuple(outs[k].shape)}" for k in expect) + "; all finite; "
        f"per-request ms {[round(t, 3) for t in times]} median "
        f"{statistics.median(times):.3f}; peak memory {peak_imp / 2**20:.1f} MiB")
    profile_request(request_importance, STAGES)
    phase_done("serve-importance", t0)

    # ---- 10. the importance renderer through the decoder kernel
    t0 = time.time()
    from pix2pix3d_tpu_torch.render.ray_sampler import sample_rays
    planes = outs["planes"]
    ray_o, ray_d = sample_rays(pose[:, :16].reshape(-1, 4, 4),
                               pose[:, 16:].reshape(-1, 3, 3), APP_NRR)
    rk = G.rendering_kwargs
    chunk = rk.get("point_chunk", 65536)
    expected = sum(math.ceil(APP_NRR ** 2 * rk[k] / chunk)
                   for k in ("depth_resolution", "depth_resolution_importance"))
    captured = []

    def recording(*a, **kw):
        if not captured:
            captured.append((a, kw))
        return dkernel(*a, **kw)

    def render(impl):
        return G.renderer(planes, lambda f, d: G.decoder(f, d, impl=impl),
                          ray_o, ray_d, rk, det=True)

    with torch.no_grad(), precision.policy(False):
        lsd.late_separate_decode = recording
        try:
            got = counts.run("importance-kernel", lambda: render("kernel"))
        finally:
            lsd.late_separate_decode = dkernel
        want = render("ref")
    d_launches = counts.by_path["late_separate_decode"]["importance-kernel"]
    dc_launches = counts.by_path["decode_composite"]["importance-kernel"]
    if (d_launches, dc_launches) != (expected, 0):
        raise AssertionError(f"one importance render launched late_separate_decode "
                             f"{d_launches} and decode_composite {dc_launches} "
                             f"times, expected {expected} and 0")
    for name, g_, w_ in zip(("features", "depth", "weight sum"), got, want):
        abs_e, rel_e, used, _ = compare((g_,), (w_,), RENDER_TOL)
        log(f"importance render, kernel vs ref decoder {name:10s} "
            f"{tuple(g_.shape)}: max abs {abs_e:.3e} rel {rel_e:.3e} "
            f"({used:.3f} of tol {RENDER_TOL})")
    log(f"importance render: late_separate_decode launches {d_launches}")

    a, kw = captured[0]
    args = tuple(a)
    check_block_diagonal(args[3], transposed=False)
    dtype = kw["compute_dtype"]
    with torch.no_grad(), precision.policy(False):
        got = dkernel(*args, **kw)
        torch.cuda.synchronize()
        want = lsd.late_separate_decode_plain(*args, **kw)
        d_abs, used, rms_c, rms_s = compare_decode(got, want, dtype)
        dkc_ms = cuda_ms(lambda: dkernel(*args, **kw), 20)
        targs = decode_typed(args, dtype)
        dk_ms = device_ms(lambda: dkernel(*targs, **kw), 20)
        dpc_ms = cuda_ms(lambda: lsd.late_separate_decode_plain(*args, **kw), 10)
        dp_ms = device_ms(lambda: lsd.late_separate_decode_plain(*args, **kw), 10)
        dlibc_ms, dlib_ms = decode_library_ms(args, dtype, 20)
    db_ms, db_by, terms = bound_decode(args, kw, sfu_per_s)
    log(f"importance-path decoder inputs: feats {tuple(args[0].shape)} "
        f"{args[0].dtype}, {kw}; bound terms: " + ", ".join(
            f"{k} {n:.4g} -> {ms:.4f} ms" for k, (n, ms) in terms.items()))
    log(f"importance-path decoder kernel: max abs {d_abs:.3e} ({used:.3f} of tol "
        f"{DECODE_TOL[dtype][0]}), RMS colors {rms_c:.3e} sigma {rms_s:.3e}; "
        f"device ms: kernel {dk_ms:.4f}, plain {dp_ms:.4f}, torch.matmul "
        f"{dlib_ms:.4f}, bound {db_ms:.4f} ({db_by}); call ms: kernel {dkc_ms:.4f}, "
        f"plain {dpc_ms:.4f}, torch.matmul {dlibc_ms:.4f}")
    log(f"importance-path decoder kernel "
        f"{achieved(terms, dk_ms, sm_clock_mhz * 1e6, n_sm)}")
    phase_done("importance kernel", t0)

    del captured, args, targs, got, want, planes
    torch.cuda.empty_cache()
    # ---- 11.-14. checkpoint, apps, apps-serving, released configs
    G_app, app = phase_checkpoint(G, cfg, device, card)
    del G
    torch.cuda.empty_cache()
    if app["neural_rendering_resolution"] != APP_NRR:
        raise AssertionError(f"app nrr {app['neural_rendering_resolution']}")
    phase_apps(G_app, app, device, card, counts)
    for name, by_path in counts.by_path.items():
        if by_path["apps"]:
            raise AssertionError(f"the apps (impl='ref') launched {name}")
    phase_apps_serving(G_app, app, device, card, counts)
    del G_app
    torch.cuda.empty_cache()
    phase_released(device, card, counts)

    # ---- 15.-16. training: card vs CPU at a small width, then the recipe
    phase_train_parity(device, card)
    phase_train(device, card, counts)

    # ---- 17.-21. ADA, sinks, the frustum sampler, remat, the autograd guard
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        folder = write_training_folder(tmp, TRAIN_IMAGES)
        log(f"train-aug: {TRAIN_IMAGES} synthetic 512^2 images and masks written in "
            f"{time.perf_counter() - t1:.2f} s")
        phase_train_aug(device, card, counts, folder, tmp)
        phase_sinks(card)
        phase_train_frustum(device, card, counts, folder, tmp)
        phase_train_remat(device, card, counts, folder, tmp)
        phase_autograd_guard(device, card, counts)
        # ---- 22.-27. the other generators of the registries
        phase_eg3d(device, card, counts, folder, tmp)
        phase_seg2cat_bg(device, card, counts, folder, tmp)
        phase_other_generators(device, card, counts)
        phase_dual_sr(device, card, counts)
        # ---- 28. the metrics package through the serving generator
        phase_metrics(device, card, counts, folder, tmp, sfu_per_s, request_ms)

    for entry in report:
        entry["launches_by_path"] = counts.by_path[entry["name"]]
    report.append({
        "name": "late_separate_decode", "route": "cuda",
        "source": "pix2pix3d_tpu_torch/csrc/late_separate_decode.cu",
        "replaces": "pix2pix3d_tpu/ops/decoder_pallas.py:113",
        "launches": d_launches, "max_abs_err": d_abs, "ms": dkc_ms,
        "plain_ms": dpc_ms, "bound_ms": db_ms, "bound_by": db_by,
        "library_ms": dlibc_ms, "device_ms": dk_ms, "plain_device_ms": dp_ms,
        "library_device_ms": dlib_ms,
        "launches_by_path": counts.by_path["late_separate_decode"]})
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
