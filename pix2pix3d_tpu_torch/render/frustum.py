"""Frustum-slab tri-plane renderer (the gather-free serving path), port of
`pix2pix3d_tpu/render/frustum.py`.

Rays are parametrized by z-depth, p(u, v, t) = o + t*(u*a_u + v*a_v + a_0),
so projecting a depth slab onto a tri-plane is an affine resample of the
plane texture whose 2x2 linear part is t*B with a depth-independent B.
Factoring B = Shear_x(a) * Shear_y(b) * diag(d1, d2) turns the render into

  1. two texture-side shear passes per plane (once, shared by all slabs),
  2. per-slab axis-aligned scale+translate (two banded matmuls),
  3. decoder MLP + front-to-back compositing over the slabs -- on the GPU
     the hand-written CUDA kernel `ops/decode_composite.py` when the fused
     decoder params are given, else the unfused decode/composite below.

Layouts follow the JAX package: planes `[N, 3, S, S, C]` feature-last,
textures `[S, S, C]`.  The window specs and the NaN-poison coverage guard
stay as the JAX package has them, and so does the per-chunk
rematerialization of training (`frustum_remat`).  Per-output-tile sub-windows
(`rendering_kwargs['frustum_tiles']`, opt-in there) are not ported; the
generator refuses the key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import decode_composite
from ..ops.bias_act import softplus


def generate_plane_axes():
    """Axis matrices of the 3 canonical planes (ref `renderer.py:23-37`)."""
    return np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                     [[0, 0, 1], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)


_INV_PLANE_AXES = np.linalg.inv(generate_plane_axes())  # [3, 3, 3]

# static shear margin (texels); |a|,|b| <= MARGIN/S is the supported range
MARGIN = 128


def _safe_div(x, y, eps=1e-8):
    small = y.abs() < eps
    return torch.where(small, torch.zeros_like(x),
                       x / torch.where(small, torch.ones_like(y), y))


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

    P = torch.as_tensor(np.transpose(_INV_PLANE_AXES, (0, 2, 1))[:, :2, :].copy(),
                        dtype=torch.float32, device=cam2world.device) \
        * (2.0 / box_warp)
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


def _band_weights(centers, in_len, in_offset=0.0, dtype=torch.float32,
                  kernel="linear"):
    """Interpolation taps W[..., o, x] = k(x + in_offset - c(o)); rows whose
    center lies outside the input come out all-zero (zeros padding).
    'linear' is the 2-tap hat, 'cubic' Catmull-Rom."""
    x = torch.arange(in_len, dtype=torch.float32, device=centers.device) + in_offset
    d = (x - centers[..., None]).abs()
    if kernel == "linear":
        w = torch.clamp_min(1.0 - d, 0.0)
    else:
        w_near = (1.5 * d - 2.5) * d * d + 1.0
        w_far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
        w = torch.where(d < 1.0, w_near,
                        torch.where(d < 2.0, w_far, torch.zeros_like(d)))
    return w.to(dtype)


def _bmm(a, b):
    """Batched product in the operands' dtype, f32 result."""
    return torch.bmm(a, b).float()


def shear_pass(tex, slope, out_len, margin, compute_dtype=torch.float32):
    """out[l, o, c] = tex sampled at (l, (o - margin) + slope*l), cubic taps
    and zeros padding.  tex [L, X, C] -> [L, out_len, C] (f32)."""
    L, X, C = tex.shape
    dev = tex.device
    lines = torch.arange(L, dtype=torch.float32, device=dev)
    centers = (torch.arange(out_len, dtype=torch.float32, device=dev)[None, :]
               - margin + slope * lines[:, None])
    W = _band_weights(centers, X, dtype=compute_dtype, kernel="cubic")
    return _bmm(W, tex.to(compute_dtype))


def shear_texture(tex, a, b, compute_dtype=torch.float32):
    """Both texture-side shears: [S, S, C] -> [S+2M, S+2M, C] covering the
    extended [-MARGIN, S+MARGIN) range on both axes."""
    S = tex.shape[0]
    ext = S + 2 * MARGIN
    dev = tex.device
    t1 = shear_pass(tex, a, ext, MARGIN, compute_dtype)        # [S, ext, C]
    t1t = t1.transpose(0, 1)                                   # [ext, S, C]
    lines_off = torch.arange(ext, dtype=torch.float32, device=dev) - MARGIN
    centers = (torch.arange(ext, dtype=torch.float32, device=dev)[None, :]
               - MARGIN + b * lines_off[:, None])
    W = _band_weights(centers, S, dtype=compute_dtype, kernel="cubic")
    t2t = _bmm(W, t1t.to(compute_dtype))                       # [ext_x, ext_y, C]
    return t2t.transpose(0, 1)


def _win_start(centers, in_len, w):
    """Start of a window of length `w` covering `centers`' taps:
    floor(min)-2 slack, clipped to the input, rounded down to a multiple of
    8 (as the JAX package does for the TPU's tiled layout)."""
    lo = float(torch.floor(centers.min()).item()) - 2.0
    if math.isnan(lo):
        return 0  # NaN-poisoned depths: the render is NaN whatever the window
    return (int(min(max(lo, 0.0), float(in_len - w))) // 8) * 8


def slab_resample(t2, t_vals, d1, d2, F0, F1, nrr, compute_dtype=torch.float32,
                  win=None, channels_first=False):
    """Per-slab axis-aligned scale+translate of the sheared texture.

    t2 [ext, ext, C], t_vals [T] -> [T, nrr, nrr, C] (or [T, C, nrr, nrr]
    with `channels_first`), f32:
      out[t, i, j] = t2 sampled at (y = t*d2*i + F_y(t), x = t*d1*j + F_x(t)).
    `win=(win_y, win_x)` contracts only a window that covers every tap --
    mathematically identical to the full contraction."""
    ext = t2.shape[0]
    ii = torch.arange(nrr, dtype=torch.float32, device=t2.device)
    cy = t_vals[:, None] * d2 * ii[None, :] + (F0[1] + t_vals[:, None] * F1[1]) \
        + MARGIN                                               # [T, nrr]
    cx = t_vals[:, None] * d1 * ii[None, :] + (F0[0] + t_vals[:, None] * F1[0]) \
        + MARGIN
    ext_y = ext_x = ext
    if win is not None and min(win) < ext:
        win_y, win_x = min(win[0], ext), min(win[1], ext)
        y0 = _win_start(cy, ext, win_y)
        x0 = _win_start(cx, ext, win_x)
        t2 = t2[y0:y0 + win_y, x0:x0 + win_x]
        cy = cy - y0
        cx = cx - x0
        ext_y, ext_x = win_y, win_x
    T, C = t_vals.shape[0], t2.shape[2]
    Wy = _band_weights(cy, ext_y, dtype=compute_dtype)         # [T, nrr, wy]
    Wx = _band_weights(cx, ext_x, dtype=compute_dtype)         # [T, nrr, wx]
    # stage 1: v[t, i, x, c] = sum_y Wy[t, i, y] t2[y, x, c]
    v = torch.matmul(Wy, t2.to(compute_dtype).reshape(ext_y, ext_x * C))
    v = v.reshape(T, nrr, ext_x, C)
    # stage 2: out[t, i, j, c] = sum_x Wx[t, j, x] v[t, i, x, c]
    if channels_first:
        # [T, C, nrr(i), nrr(j)] for the fused decode+composite kernel
        vt = v.permute(0, 3, 1, 2).reshape(T, C * nrr, ext_x)
        out = torch.bmm(vt, Wx.transpose(1, 2))                # [T, C*i, j]
        return out.float().reshape(T, C, nrr, nrr)
    vt = v.reshape(T, nrr, ext_x, C)
    out = torch.einsum("tjx,tixc->tijc", Wx, vt)
    return out.float()


def prepare_textures(planes, coeffs, compute_dtype=torch.float32):
    """Shear all plane textures once (shared across every depth slab)."""
    n, q, S, _, c = planes.shape
    a, b, d1, d2, F0, F1, flip = factor_shears(coeffs["B"], coeffs["E0"],
                                               coeffs["E1"])
    tex = planes.reshape(n * q, S, S, c)
    tex = torch.where(flip.reshape(n * q)[:, None, None, None],
                      tex.transpose(1, 2), tex)
    a, b = a.reshape(-1), b.reshape(-1)
    sheared = torch.stack([shear_texture(tex[i], a[i], b[i], compute_dtype)
                           for i in range(n * q)])
    return {"tex": sheared, "d1": d1.reshape(-1), "d2": d2.reshape(-1),
            "F0": F0.reshape(-1, 2), "F1": F1.reshape(-1, 2), "n": n, "q": q}


def sample_slabs_prepared(prep, t_vals, nrr, compute_dtype=torch.float32,
                          win=None, channels_first=False):
    """[N, T, nrr, nrr, C] (or [N, T, C, nrr, nrr]) mean-over-planes
    features for depth values t_vals [N, T], in compute_dtype."""
    n, q = prep["n"], prep["q"]
    out = []
    for i in range(n):
        acc = 0.0
        for qi in range(q):
            k = i * q + qi
            acc = acc + slab_resample(prep["tex"][k], t_vals[i], prep["d1"][k],
                                      prep["d2"][k], prep["F0"][k], prep["F1"][k],
                                      nrr, compute_dtype, win=win,
                                      channels_first=channels_first)
        out.append((acc / q).to(compute_dtype))
    return torch.stack(out)


def window_coverage_violation(prep, t_vals, nrr, win, chunk):
    """0-dim bool tensor: does ANY chunk's contraction window miss a tap the
    full contraction would use?  Mirrors `slab_resample`'s window math
    (same centers, same floor/clip/multiple-of-8 start) outside the hot
    loop; off-texture centers give zeros on both paths, so they are clipped
    to the texture before the comparison."""
    ext = prep["tex"].shape[1]
    n, q = prep["n"], prep["q"]
    dev = t_vals.device
    win_y, win_x = min(win[0], ext), min(win[1], ext)
    if win_y >= ext and win_x >= ext:
        return torch.zeros((), dtype=torch.bool, device=dev)
    ii = torch.arange(nrr, dtype=torch.float32, device=dev)
    ch = t_vals.reshape(n, -1, chunk)                         # [N, CH, TC]

    def centers(d, f0, f1):
        d = d.reshape(n, q)[:, :, None, None, None]
        f0 = f0.reshape(n, q)[:, :, None, None, None]
        f1 = f1.reshape(n, q)[:, :, None, None, None]
        t = ch[:, None, :, :, None]
        return t * d * ii + f0 + t * f1 + MARGIN              # [N, q, CH, TC, nrr]

    def win_bad(c, win_len):
        cc = c.clamp(0.0, ext - 1.0)
        lo = torch.floor(c.amin(dim=(3, 4))) - 2.0
        start = torch.floor(lo.clamp(0, ext - win_len) / 8) * 8
        hi_bad = cc.amax(dim=(3, 4)) > start + (win_len - 1.0)
        lo_bad = cc.amin(dim=(3, 4)) < start
        return (hi_bad | lo_bad).any()

    bad = torch.zeros((), dtype=torch.bool, device=dev)
    if win_y < ext:
        bad = bad | win_bad(centers(prep["d2"], prep["F0"][:, 1], prep["F1"][:, 1]),
                            win_y)
    if win_x < ext:
        bad = bad | win_bad(centers(prep["d1"], prep["F0"][:, 0], prep["F1"][:, 0]),
                            win_x)
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
                   nrr, depth_steps=None, chunk=None, window=None,
                   compute_dtype=torch.float32, fused_decoder=None):
    """Gather-free render -> (features [N, R, 64], depth [N, R, 1],
    weights [N, R, 1]), as `ImportanceRenderer` returns them.

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
    if window is None:
        window = default_window(S, opts["box_warp"], nrr, chunk, T)
    dev = planes.device

    coeffs = frustum_coeffs(cam2world, intrinsics, nrr, S, opts["box_warp"])
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
    bad = window_coverage_violation(prep, t_vals, nrr, window, chunk)
    t_vals = t_vals + torch.where(bad, float("nan"), 0.0) * 0.0

    if fused_decoder is not None:
        ch_n = T // chunk
        feats = torch.stack([
            sample_slabs_prepared(prep, t_vals[:, k * chunk:(k + 1) * chunk], nrr,
                                  compute_dtype, win=window, channels_first=True)
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
        feats = sample_slabs_prepared(prep, t_chunk, nrr, compute_dtype, win=window)
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
    # decoder activations and colors (O(T * nrr^2 * 64) at nrr 128).  The
    # recompute repeats the chunk's window-start syncs.  Without gradients
    # (serving) nothing changes.  Off with rendering_kwargs['frustum_remat']
    # = False.
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
