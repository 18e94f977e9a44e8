"""Frustum-slab tri-plane renderer (the gather-free serving path), port of
`pix2pix3d_tpu/render/frustum.py`.

Rays are parametrized by z-depth, p(u, v, t) = o + t*(u*a_u + v*a_v + a_0),
so projecting a depth slab onto a tri-plane is an affine resample of the
plane texture whose 2x2 linear part is t*B with a depth-independent B.
Factoring B = Shear_x(a) * Shear_y(b) * diag(d1, d2) turns the render into

  1. two texture-side shear passes per plane (once, shared by all slabs) --
     without gradients one call of `ops/shear_textures.py` over every image
     and plane, on the GPU one hand-written CUDA kernel,
  2. per-slab axis-aligned scale+translate (two banded matmuls),
  3. decoder MLP + front-to-back compositing over the slabs -- on the GPU
     the hand-written CUDA kernel `ops/decode_composite.py` when the fused
     decoder params are given, else the unfused decode/composite below.

Planes are `[N, 3, S, S, C]` feature-last as in the JAX package; the
sheared textures are `[ext, C, ext]` (rows, channels, columns).  The
contraction window (one per chunk), the NaN-poison coverage guard and the
per-chunk rematerialization of training (`frustum_remat`) stay as the JAX
package has them.  A window's start depends on the depths:
`resample_slabs` finds every texture's starts on the device and runs all
N*3 windows of a chunk as batched products, so the render reads nothing
back to the host.  Under a profiler the render's host work shows as
`render.prepare` (the shears) and one `render.slabs` span per chunk (the
slab resamples).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import decode_composite
from ..ops.bias_act import softplus
from ..ops.shear_textures import MARGIN, shear_textures, shear_textures_plain
from ..utils.profiling import annotate
from .renderer import _INV_PLANE_AXES


def _safe_div(x, y, eps=1e-8):
    small = y.abs() < eps
    return torch.where(small, torch.zeros_like(x),
                       x / torch.where(small, torch.ones_like(y), y))


@functools.lru_cache(maxsize=None)
def _plane_projection(device):
    """The planes' first two inverse axes, [3 planes, 2, 3], copied to each
    device once (a copy per render would block the host on the card)."""
    return torch.as_tensor(np.transpose(_INV_PLANE_AXES, (0, 2, 1))[:, :2, :].copy(),
                           dtype=torch.float32, device=device)


def frustum_coeffs(cam2world, intrinsics, nrr, plane_res, box_warp):
    """Per-(image, plane) affine coefficients of the slab resample:
    B [N, 3, 2, 2], E0/E1 [N, 3, 2] (translation E0 + t*E1, texels) and the
    world-space ray basis a_u, a_v, a_0 [N, 3]."""
    R = cam2world[:, :3, :3]
    o = cam2world[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    R0, R1, R2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
    a_u = R0 / fx
    a_v = R1 / fy - R0 * sk / (fx * fy)
    a_0 = R2 - R0 * (cx - cy * sk / fy) / fx - R1 * cy / fy

    P = _plane_projection(cam2world.device) * (2.0 / box_warp)
    s_half = plane_res / 2.0

    def proj(vec):  # [N, 3] world -> [N, 3 planes, 2] texel-scaled
        return torch.einsum("pij,nj->npi", P, vec) * s_half

    pu, pv, p0 = proj(a_u), proj(a_v), proj(a_0)
    tau0 = torch.einsum("pij,nj->npi", P, o) * s_half + (s_half - 0.5)
    inv = 1.0 / nrr
    B = torch.stack([pu * inv, pv * inv], dim=-1)          # [N, 3, 2, 2]
    E1 = p0 + (pu + pv) * (0.5 * inv)
    return {"B": B, "E0": tau0, "E1": E1, "a_u": a_u, "a_v": a_v, "a_0": a_0}


def factor_shears(B, E0, E1):
    """B = Shx(a)*Shy(b)*diag(d1,d2) with a per-(image, plane) transpose
    pivot; returns (a, b, d1, d2, F0, F1, flip)."""
    flip = B[..., 1, 1].abs() < B[..., 0, 1].abs()          # [N, 3]
    B = torch.where(flip[..., None, None], B.flip(-2), B)
    E0 = torch.where(flip[..., None], E0.flip(-1), E0)
    E1 = torch.where(flip[..., None], E1.flip(-1), E1)
    b11, b12 = B[..., 0, 0], B[..., 0, 1]
    b21, b22 = B[..., 1, 0], B[..., 1, 1]
    a = _safe_div(b12, b22)
    d1 = b11 - a * b21
    b = _safe_div(b21, d1)
    d2 = b22
    ex0, ey0 = E0[..., 0] - a * E0[..., 1], E0[..., 1]
    ex1, ey1 = E1[..., 0] - a * E1[..., 1], E1[..., 1]
    F0 = torch.stack([ex0, ey0 - b * ex0], -1)
    F1 = torch.stack([ex1, ey1 - b * ex1], -1)
    return a, b, d1, d2, F0, F1, flip


def _band_weights(centers, in_len, dtype=torch.float32):
    """Linear (2-tap hat) taps W[..., o, x] = max(0, 1 - |x - c(o)|); rows
    whose center lies outside the input come out all-zero (zeros padding)."""
    x = torch.arange(in_len, dtype=torch.float32, device=centers.device)
    return torch.clamp_min(1.0 - (x - centers[..., None]).abs(), 0.0).to(dtype)


def _win_starts(lo_center, in_len, w):
    """Starts of windows of length `w` covering taps whose smallest centers
    are `lo_center` (a tensor): floor(min)-2 slack, clipped to the input,
    rounded down to a multiple of 8 (as the JAX package does for the TPU's
    tiled layout); 0 where the minimum is NaN (NaN-poisoned depths: the
    render is NaN whatever the window).  Integer values in float32."""
    lo = (torch.floor(lo_center) - 2.0).clamp(0, in_len - w)
    return torch.nan_to_num(torch.floor(lo / 8) * 8, nan=0.0)


def _centers(t_vals, d1, d2, F0, F1, nrr):
    """Texel centers (cy, cx), each [K, T, nrr], of every slab's outputs,
    t*d*i + (f0 + t*f1) + MARGIN per axis, for K = N*q textures (image n's
    are n*q .. n*q+q-1) at depths t_vals [N, T]; d1/d2 [K], F0/F1 [K, 2]."""
    n, T = t_vals.shape
    K = d1.shape[0]
    t = t_vals[:, None].expand(n, K // n, T).reshape(K, T)[:, :, None]
    ii = torch.arange(nrr, dtype=torch.float32, device=t_vals.device)

    def axis(d, f0, f1):
        return t * d[:, None, None] * ii + (f0[:, None, None] + t * f1[:, None, None]) \
            + MARGIN

    return axis(d2, F0[:, 1], F1[:, 1]), axis(d1, F0[:, 0], F1[:, 0])


def resample_slabs(tex, t_vals, d1, d2, F0, F1, nrr, compute_dtype=torch.float32,
                   win=None, channels_first=False):
    """Per-slab axis-aligned scale+translate of K = N*q sheared textures,
    averaged over each image's q planes (textures n*q .. n*q+q-1).

    tex [K, ext, C, ext] (rows, channels, columns: `prepare_textures`'
    layout), t_vals [N, T], d1/d2 [K], F0/F1 [K, 2] -> [N, T, nrr, nrr, C]
    (or [N, T, C, nrr, nrr] with `channels_first`) in compute_dtype:
      out[n, t, i, j] = mean_p tex[n*q+p] sampled at
                        (y = t*d2*i + F_y(t), x = t*d1*j + F_x(t)).
    `win=(win_y, win_x)` contracts only each texture's window that covers
    every tap -- mathematically identical to the full contraction.  The
    starts are found on the device, so nothing is read back to the host:
    the window's rows are gathered with one index (a contiguous block of
    channels and columns each), its columns by zero weight outside it."""
    K, ext, C, _ = tex.shape
    n, T = t_vals.shape
    q = K // n
    dev = tex.device
    cy, cx = _centers(t_vals, d1, d2, F0, F1, nrr)           # [K, T, nrr]
    win_y, win_x = (ext, ext) if win is None else (min(win[0], ext), min(win[1], ext))
    Wx = _band_weights(cx, ext, dtype=compute_dtype)          # [K, T, nrr, ext]
    if win_x < ext:
        x0 = _win_starts(cx.amin(dim=(1, 2)), ext, win_x)[:, None]
        x = torch.arange(ext, dtype=torch.float32, device=dev)
        Wx = Wx * ((x >= x0) & (x < x0 + win_x))[:, None, None]
    if win_y < ext:
        y0 = _win_starts(cy.amin(dim=(1, 2)), ext, win_y)
        rows = (torch.arange(0, K * ext, ext, device=dev)[:, None] + y0.long()[:, None]
                + torch.arange(win_y, device=dev))
        tex = tex.reshape(K * ext, C * ext).index_select(0, rows.reshape(-1))
        cy = cy - y0[:, None, None]
    Wy = _band_weights(cy, win_y, dtype=compute_dtype)         # [K, T, nrr, wy]
    # stage 1: v[k, t, i, c, x] = sum_y Wy[k, t, i, y] tex[k, y, c, x]
    v = torch.bmm(Wy.reshape(K, T * nrr, win_y),
                  tex.to(compute_dtype).reshape(K, win_y, C * ext))
    # stage 2: o[k, t, i, c, j] = sum_x v[k, t, i, c, x] Wx[k, t, j, x]
    o = torch.bmm(v.reshape(K * T, nrr * C, ext), Wx.reshape(K * T, nrr, ext).transpose(1, 2))
    o = o.reshape(n, q, T, nrr, C, nrr)
    # the mean over each image's planes, in the layout asked for
    if channels_first:
        return o.permute(0, 1, 2, 4, 3, 5).mean(1)            # [N, T, C, i, j]
    return o.permute(0, 1, 2, 3, 5, 4).mean(1)                # [N, T, i, j, C]


def prepare_textures(planes, coeffs, compute_dtype=torch.float32):
    """Shear all plane textures once (shared across every depth slab):
    `tex` [N*3, ext, C, ext], rows, channels, columns, so that a window's
    rows are one block and stage 1's product keeps each output row's
    channels together.  Without gradients one `ops.shear_textures` call
    shears every texture (on the card one kernel launch) into
    compute_dtype; with gradients the per-texture band-matrix shears run,
    f32, and each window is cast where the slabs read it, so the textures'
    gradient sums the chunks in f32 as JAX's does."""
    n, q = planes.shape[:2]
    a, b, d1, d2, F0, F1, flip = factor_shears(coeffs["B"], coeffs["E0"],
                                               coeffs["E1"])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (planes, a, b)):
        sheared = shear_textures_plain(planes, a, b, flip, compute_dtype)
    else:
        sheared = shear_textures(planes, a, b, flip, compute_dtype)
    return {"tex": sheared, "d1": d1.reshape(-1), "d2": d2.reshape(-1),
            "F0": F0.reshape(-1, 2), "F1": F1.reshape(-1, 2), "n": n, "q": q}


def sample_slabs_prepared(prep, t_vals, nrr, compute_dtype=torch.float32,
                          win=None, channels_first=False):
    """[N, T, nrr, nrr, C] (or [N, T, C, nrr, nrr]) mean-over-planes
    features for depth values t_vals [N, T], in compute_dtype: one
    `resample_slabs` over every image and plane."""
    return resample_slabs(prep["tex"], t_vals, prep["d1"], prep["d2"], prep["F0"],
                          prep["F1"], nrr, compute_dtype, win=win,
                          channels_first=channels_first)


def window_coverage_violation(prep, t_vals, nrr, win, chunk, tiles=None):
    """0-dim bool tensor: does ANY chunk's contraction window miss a tap the
    full contraction would use?  Mirrors the resample's window math (the
    centers as JAX's guard orders them, the same `_win_starts`) outside the
    hot loop; off-texture centers give zeros on both paths, so they are
    clipped to the texture before the comparison.  With `tiles`, checks the
    tiles as JAX's tiled path has them: per-i-tile y-windows and the union
    x-window against the texture, per-j-tile x-windows against the union
    window."""
    ext = prep["tex"].shape[1]
    n, q = prep["n"], prep["q"]
    dev = t_vals.device
    ii = torch.arange(nrr, dtype=torch.float32, device=dev)
    ch = t_vals.reshape(n, -1, chunk)                         # [N, CH, TC]
    no = torch.zeros((), dtype=torch.bool, device=dev)

    def centers(d, f0, f1):
        d = d.reshape(n, q)[:, :, None, None, None]
        f0 = f0.reshape(n, q)[:, :, None, None, None]
        f1 = f1.reshape(n, q)[:, :, None, None, None]
        t = ch[:, None, :, :, None]
        return t * d * ii + f0 + t * f1 + MARGIN              # [N, q, CH, TC, nrr]

    def win_bad(c, cc, in_len, win_len, group=None):
        """Coverage failure of the window over the trailing output axis
        (optionally split into tiles of `group` outputs).  `c` drives the
        start (the resample uses UNCLIPPED centers); `cc` holds the
        texture-clipped centers whose taps carry weight.  Both may be offset
        into a parent window whose extent is `in_len`."""
        red = (3, 4)
        if group is not None:
            c = c.reshape(*c.shape[:4], -1, group)
            cc = cc.reshape(*cc.shape[:4], -1, group)
            red = (3, 5)
        s = _win_starts(c.amin(dim=red), in_len, win_len)
        hi_bad = cc.amax(dim=red) > s + (win_len - 1.0)
        lo_bad = cc.amin(dim=red) < s
        return (hi_bad | lo_bad).any()

    if tiles is None and min(win) >= ext:
        return no
    cy = centers(prep["d2"], prep["F0"][:, 1], prep["F1"][:, 1])
    cx = centers(prep["d1"], prep["F0"][:, 0], prep["F1"][:, 0])
    if tiles is not None:
        gi, wy_t, gj, wx_t, wxu = tiles
        wxu, wy_t = min(wxu, ext), min(wy_t, ext)
        wx_t = min(wx_t, wxu)
        bad = win_bad(cy, cy.clamp(0.0, ext - 1.0), ext, wy_t, group=gi) \
            if wy_t < ext else no
        ccx = cx.clamp(0.0, ext - 1.0)
        if wxu < ext:
            bad = bad | win_bad(cx, ccx, ext, wxu)
            x0u = _win_starts(cx.amin(dim=(3, 4)), ext, wxu)[..., None, None]
            cx, ccx = cx - x0u, ccx - x0u
        if wx_t < wxu:
            bad = bad | win_bad(cx, ccx, wxu, wx_t, group=gj)
        return bad

    win_y, win_x = min(win[0], ext), min(win[1], ext)
    bad = no
    if win_y < ext:
        bad = bad | win_bad(cy, cy.clamp(0.0, ext - 1.0), ext, win_y)
    if win_x < ext:
        bad = bad | win_bad(cx, cx.clamp(0.0, ext - 1.0), ext, win_x)
    return bad


def default_window(S, box_warp, nrr, chunk, T):
    """Contraction window of the JAX package's auto-selection
    (`render/frustum.py:491-514`): calibrated on the seg2cat plane geometry
    (S=256, box_warp=1); anything else gets the exact full contraction."""
    ext_full = S + 2 * MARGIN
    std_geom = S == 256 and float(box_warp) == 1.0
    if std_geom and nrr <= 128 and chunk / T <= 1 / 12:
        return (256, 384)
    if std_geom and nrr <= 128 and chunk / T <= 1 / 6:
        return (384, 448)
    return (ext_full, ext_full)


def composite_step(carry, colors, sigmas, depths):
    """Front-to-back midpoint compositing of one decoded slab chunk, seamed
    to the previous chunk's last sample through the carry.  colors
    [N, tc, R, Cc], sigmas/depths [N, tc, R]."""
    prev_c, prev_s, prev_d, trans, acc_rgb, acc_d, acc_w = carry
    ss = torch.cat([prev_s[:, None], sigmas], dim=1)
    dd = torch.cat([prev_d[:, None], depths], dim=1)
    deltas = dd[:, 1:] - dd[:, :-1]
    sig_mid = softplus((ss[:, :-1] + ss[:, 1:]) / 2 - 1)
    alpha = 1 - torch.exp(-sig_mid * deltas)                  # [N, tc, R]
    one_m = 1 - alpha + 1e-10
    trans_in = trans[:, None] * torch.cat(
        [torch.ones_like(one_m[:, :1]), torch.cumprod(one_m[:, :-1], dim=1)], dim=1)
    w = alpha * trans_in
    w_shift = 0.5 * (w + torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], dim=1))
    acc_rgb = (acc_rgb + prev_c.float() * (0.5 * w[:, 0])[..., None]
               + torch.einsum("ntr,ntrc->nrc", w_shift, colors.float()))
    acc_d = acc_d + prev_d * 0.5 * w[:, 0] + (w_shift * depths).sum(dim=1)
    acc_w = acc_w + w.sum(dim=1)
    trans = trans * one_m.prod(dim=1)
    return (colors[:, -1], sigmas[:, -1], depths[:, -1], trans, acc_rgb, acc_d,
            acc_w)


def frustum_render(planes, decoder, cam2world, intrinsics, rendering_options,
                   nrr, depth_steps=None, chunk=None, window=None, tiles=None,
                   compute_dtype=torch.float32, fused_decoder=None):
    """Gather-free render -> (features [N, R, 64], depth [N, R, 1],
    weights [N, R, 1]), as `ImportanceRenderer` returns them.  Without
    `window`, `default_window` picks one per chunk.  `tiles` (gi, wy, gj,
    wx, union), JAX's per-output-tile windows, takes precedence: the
    resample contracts full rows and the tiles' union x-window, and the
    coverage guard checks the tiles, so the render equals the full
    contraction wherever the tiles cover every tap and is NaN elsewhere.

    decoder(feats [N, 1, M, C], dirs [N, M, 3]) -> {'rgb', 'sigma'} is used
    by the unfused path.  fused_decoder = (w1t, b1, w2t, b2, sem_sigmoid)
    sends decode AND composite through
    `ops.decode_composite.fused_decode_composite` instead."""
    opts = rendering_options
    if opts["ray_start"] == "auto":
        raise ValueError("frustum sampler needs static ray_start/ray_end")
    n = cam2world.shape[0]
    S = planes.shape[2]
    T = depth_steps or (opts["depth_resolution"] + opts["depth_resolution_importance"])
    chunk = chunk or min(T, 8)
    if T % chunk:
        raise ValueError(f"depth steps {T} not a multiple of chunk {chunk}")
    if tiles is not None:
        window = (S + 2 * MARGIN, tiles[4])
    elif window is None:
        window = default_window(S, opts["box_warp"], nrr, chunk, T)
    dev = planes.device

    coeffs = frustum_coeffs(cam2world, intrinsics, nrr, S, opts["box_warp"])
    with annotate("render.prepare"):
        prep = prepare_textures(planes, coeffs, compute_dtype)

    # per-ray direction norms (z-depth t -> Euclidean depth t*|d|)
    ii = (torch.arange(nrr, dtype=torch.float32, device=dev) + 0.5) / nrr
    vv, uu = torch.meshgrid(ii, ii, indexing="ij")
    d = (uu.reshape(-1)[None, :, None] * coeffs["a_u"][:, None, :]
         + vv.reshape(-1)[None, :, None] * coeffs["a_v"][:, None, :]
         + coeffs["a_0"][:, None, :])                         # [N, R, 3]
    dnorm = torch.linalg.norm(d, dim=-1)                      # [N, R]
    dirs = d / dnorm[..., None]

    t_lo = opts["ray_start"] / dnorm.amax(dim=1)              # [N]
    t_hi = opts["ray_end"] / dnorm.amin(dim=1)
    steps = torch.linspace(0.0, 1.0, T, device=dev)
    t_vals = t_lo[:, None] + steps[None, :] * (t_hi - t_lo)[:, None]  # [N, T]
    r = nrr * nrr

    # Coverage guard for the windowed contraction: a camera outside the
    # calibrated envelope NaN-poisons the depth grid (and so the render)
    # instead of silently fading to zero.
    bad = window_coverage_violation(prep, t_vals, nrr, window, chunk, tiles=tiles)
    t_vals = t_vals + torch.where(bad, float("nan"), 0.0) * 0.0

    def slabs(t_chunk, channels_first=False):
        with annotate("render.slabs"):
            return sample_slabs_prepared(prep, t_chunk, nrr, compute_dtype, win=window,
                                         channels_first=channels_first)

    if fused_decoder is not None:
        ch_n = T // chunk
        feats = torch.stack([
            slabs(t_vals[:, k * chunk:(k + 1) * chunk], channels_first=True)
            .reshape(n, chunk, -1, r)
            for k in range(ch_n)])                            # [CH, N, TC, C, r]
        w1t, b1, w2t, b2, sem_sig = fused_decoder
        acc_rgb_t, acc_d, acc_w = decode_composite.fused_decode_composite(
            feats, t_vals.contiguous(), dnorm.contiguous(), w1t, b1, w2t, b2,
            sem_sigmoid=sem_sig,
            carry_f32=bool(opts.get("fused_carry_f32", False)))
        return _finalize(acc_rgb_t.transpose(1, 2), acc_d, acc_w, t_vals, dnorm,
                         opts)

    def decode_chunk(t_chunk):
        feats = slabs(t_chunk)
        tc = t_chunk.shape[1]
        feats = feats.reshape(n, 1, tc * r, -1).to(compute_dtype)
        dirs_b = dirs[:, None].expand(n, tc, r, 3).reshape(n, tc * r, 3)
        out = decoder(feats, dirs_b)
        colors = out["rgb"].reshape(n, tc, r, -1).to(compute_dtype)
        sigmas = out["sigma"].reshape(n, tc, r).float()
        depths = t_chunk[:, :, None] * dnorm[:, None, :]      # [N, tc, R]
        return colors, sigmas, depths

    def first_chunk(t_chunk):
        """The first chunk seeds the carry with its own first sample and
        composites the rest."""
        colors0, sigmas0, depths0 = decode_chunk(t_chunk)
        carry = (colors0[:, 0], sigmas0[:, 0], depths0[:, 0],
                 torch.ones((n, r), device=dev),
                 torch.zeros((n, r, colors0.shape[-1]), device=dev),
                 torch.zeros((n, r), device=dev), torch.zeros((n, r), device=dev))
        return composite_step(carry, colors0[:, 1:], sigmas0[:, 1:], depths0[:, 1:])

    def next_chunk(carry, t_chunk):
        return composite_step(carry, *decode_chunk(t_chunk))

    # Per-chunk rematerialization (JAX `frustum.py:635-672`): with
    # gradients, each chunk's decode+composite is recomputed in the backward
    # pass, so only the carry survives a chunk, not its slab features,
    # decoder activations and colors (O(T * nrr^2 * 64) at nrr 128).
    # Without gradients (serving) nothing changes.  Off with
    # rendering_kwargs['frustum_remat'] = False.
    rematerialize = opts.get("frustum_remat", True) and torch.is_grad_enabled()

    def remat(fn, *args):
        if rematerialize:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    carry = remat(first_chunk, t_vals[:, :chunk])
    for k in range(1, T // chunk):
        carry = remat(next_chunk, carry, t_vals[:, k * chunk:(k + 1) * chunk])
    _, _, _, _, acc_rgb, acc_d, acc_w = carry
    return _finalize(acc_rgb, acc_d, acc_w, t_vals, dnorm, opts)


def _finalize(acc_rgb, acc_d, acc_w, t_vals, dnorm, opts):
    depth = acc_d / torch.clamp_min(acc_w, 1e-10)
    depth = torch.nan_to_num(depth, nan=float("inf"))
    lo = (t_vals * dnorm.min()).min()
    hi = (t_vals * dnorm.max()).max()
    depth = torch.minimum(torch.maximum(depth, lo), hi)
    if opts.get("white_back", False):
        acc_rgb = acc_rgb + (1 - acc_w)[..., None]
    acc_rgb = acc_rgb * 2 - 1
    return acc_rgb, depth[..., None], acc_w[..., None]
