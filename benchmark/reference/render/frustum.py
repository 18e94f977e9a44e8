"""Frustum-slab tri-plane render, plain: the benchmark's reference for the
serving sampler.

Rays are parametrized by z-depth, p(u, v, t) = o + t*(u*a_u + v*a_v + a_0),
so a depth slab projects onto a tri-plane as an affine resample of the
plane texture whose 2x2 linear part is t*B.  B = Shear_x(a) * Shear_y(b) *
diag(d1, d2): two cubic shear passes per plane texture, then per slab an
axis-aligned bilinear scale+translate, then the lateSeparate decoder and
front-to-back midpoint compositing over the slabs.

What the serving program computes, without its shortcuts: every resample
contracts the whole sheared texture (no contraction window, no host-side
window starts, no coverage guard), the decoder runs as its two MLPs layer
by layer, and compositing carries f32.  The resampling runs inside the
`Resample` module, so the benchmark's operation count can tell the
interpolation products from the model's own.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.bias_act import softplus


def generate_plane_axes():
    return np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                     [[0, 0, 1], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)


_INV_PLANE_AXES = np.linalg.inv(generate_plane_axes())  # [3, 3, 3]

# shear margin (texels) on each side of the sheared texture
MARGIN = 128


def _safe_div(x, y, eps=1e-8):
    small = y.abs() < eps
    return torch.where(small, torch.zeros_like(x),
                       x / torch.where(small, torch.ones_like(y), y))


def frustum_coeffs(cam2world, intrinsics, nrr, plane_res, box_warp):
    """Per-(image, plane) affine coefficients: B [N, 3, 2, 2], E0/E1
    [N, 3, 2] (translation E0 + t*E1, in texels) and the ray basis a_u, a_v,
    a_0 [N, 3]."""
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
                        dtype=torch.float32, device=cam2world.device) * (2.0 / box_warp)
    s_half = plane_res / 2.0

    def proj(vec):
        return (P[None] * vec[:, None, None, :]).sum(-1) * s_half   # [N, 3, 2]

    pu, pv, p0 = proj(a_u), proj(a_v), proj(a_0)
    tau0 = proj(o) + (s_half - 0.5)
    inv = 1.0 / nrr
    B = torch.stack([pu * inv, pv * inv], dim=-1)
    E1 = p0 + (pu + pv) * (0.5 * inv)
    return {"B": B, "E0": tau0, "E1": E1, "a_u": a_u, "a_v": a_v, "a_0": a_0}


def factor_shears(B, E0, E1):
    """B = Shx(a)*Shy(b)*diag(d1,d2), transposing the (image, plane) pairs
    whose B is closer to a swap; returns (a, b, d1, d2, F0, F1, flip)."""
    flip = B[..., 1, 1].abs() < B[..., 0, 1].abs()
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


def taps(centers, in_len, kernel):
    """Interpolation weights W[..., o, x] = k(x - c(o)) over the whole
    input, zeros outside it: 'linear' the 2-tap hat, 'cubic' Catmull-Rom."""
    x = torch.arange(in_len, dtype=torch.float32, device=centers.device)
    d = (x - centers[..., None]).abs()
    if kernel == "linear":
        return torch.clamp_min(1.0 - d, 0.0)
    w_near = (1.5 * d - 2.5) * d * d + 1.0
    w_far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return torch.where(d < 1.0, w_near, torch.where(d < 2.0, w_far, torch.zeros_like(d)))


class Resample(nn.Module):
    """The texture-side shears and the per-slab scale+translate (no
    parameters)."""

    def shear(self, tex, a, b):
        """[S, S, C] -> [S+2M, S+2M, C]: x sampled at (o - M) + a*y, then y
        at (o - M) + b*x, cubic taps."""
        S = tex.shape[0]
        ext = S + 2 * MARGIN
        dev = tex.device
        lines = torch.arange(S, dtype=torch.float32, device=dev)
        c1 = torch.arange(ext, dtype=torch.float32, device=dev)[None, :] - MARGIN \
            + a * lines[:, None]                                   # [S(y), ext(x)]
        t1 = torch.matmul(taps(c1, S, "cubic"), tex)               # [S(y), ext(x), C]
        lines_x = torch.arange(ext, dtype=torch.float32, device=dev) - MARGIN
        c2 = torch.arange(ext, dtype=torch.float32, device=dev)[None, :] - MARGIN \
            + b * lines_x[:, None]                                 # [ext(x), ext(y)]
        t2 = torch.matmul(taps(c2, S, "cubic"), t1.transpose(0, 1))  # [x, y, C]
        return t2.transpose(0, 1)

    def forward(self, planes, coeffs, t_vals, nrr):
        """Mean over the 3 planes of the slab samples: planes [N, 3, S, S, C],
        t_vals [N, T] -> [N, T, nrr, nrr, C]."""
        n, q, S, _, c = planes.shape
        a, b, d1, d2, F0, F1, flip = factor_shears(coeffs["B"], coeffs["E0"],
                                                   coeffs["E1"])
        ii = torch.arange(nrr, dtype=torch.float32, device=planes.device)
        out = []
        for i in range(n):
            acc = 0.0
            for p in range(q):
                tex = planes[i, p]
                tex = torch.where(flip[i, p], tex.transpose(0, 1), tex)
                t2 = self.shear(tex, a[i, p], b[i, p])
                ext = t2.shape[0]
                t = t_vals[i][:, None]
                cy = t * d2[i, p] * ii + (F0[i, p, 1] + t * F1[i, p, 1]) + MARGIN
                cx = t * d1[i, p] * ii + (F0[i, p, 0] + t * F1[i, p, 0]) + MARGIN
                v = torch.matmul(taps(cy, ext, "linear"), t2.reshape(ext, -1))
                v = v.reshape(t.shape[0], nrr, ext, c)             # [T, i, x, C]
                acc = acc + torch.matmul(taps(cx, ext, "linear")[:, None], v)
            out.append(acc / q)                                    # [T, i, j, C]
        return torch.stack(out)


def composite(colors, sigmas, depths):
    """Front-to-back midpoint compositing over all T samples of each ray:
    colors [N, T, R, Cc], sigmas and depths [N, T, R] -> (rgb [N, R, Cc],
    depth sum [N, R], weight sum [N, R]), unnormalized."""
    deltas = depths[:, 1:] - depths[:, :-1]
    sig_mid = softplus((sigmas[:, 1:] + sigmas[:, :-1]) * 0.5 - 1.0)
    alpha = 1.0 - torch.exp(-sig_mid * deltas)                     # [N, T-1, R]
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1] + 1e-10], dim=1), dim=1)
    w = alpha * trans
    rgb = (0.5 * w[..., None] * (colors[:, 1:] + colors[:, :-1])).sum(dim=1)
    depth = (0.5 * w * (depths[:, 1:] + depths[:, :-1])).sum(dim=1)
    return rgb, depth, w.sum(dim=1)


def finalize(acc_rgb, acc_d, acc_w, t_vals, dnorm, opts):
    depth = acc_d / torch.clamp_min(acc_w, 1e-10)
    depth = torch.nan_to_num(depth, nan=float("inf"))
    lo = (t_vals * dnorm.min()).min()
    hi = (t_vals * dnorm.max()).max()
    depth = torch.minimum(torch.maximum(depth, lo), hi)
    if opts.get("white_back", False):
        acc_rgb = acc_rgb + (1 - acc_w)[..., None]
    return acc_rgb * 2 - 1, depth[..., None], acc_w[..., None]


def frustum_render(planes, decoder, resample, cam2world, intrinsics, opts, nrr,
                   depth_steps):
    """-> (features [N, R, 64], depth [N, R, 1], weights [N, R, 1])."""
    n = cam2world.shape[0]
    S = planes.shape[2]
    T = depth_steps
    dev = planes.device
    coeffs = frustum_coeffs(cam2world, intrinsics, nrr, S, opts["box_warp"])
    ii = (torch.arange(nrr, dtype=torch.float32, device=dev) + 0.5) / nrr
    vv, uu = torch.meshgrid(ii, ii, indexing="ij")
    d = (uu.reshape(-1)[None, :, None] * coeffs["a_u"][:, None, :]
         + vv.reshape(-1)[None, :, None] * coeffs["a_v"][:, None, :]
         + coeffs["a_0"][:, None, :])                              # [N, R, 3]
    dnorm = torch.linalg.norm(d, dim=-1)
    dirs = d / dnorm[..., None]
    t_lo = opts["ray_start"] / dnorm.amax(dim=1)
    t_hi = opts["ray_end"] / dnorm.amin(dim=1)
    steps = torch.linspace(0.0, 1.0, T, device=dev)
    t_vals = t_lo[:, None] + steps[None, :] * (t_hi - t_lo)[:, None]   # [N, T]
    r = nrr * nrr
    feats = resample(planes, coeffs, t_vals, nrr).reshape(n, 1, T * r, -1)
    dirs_b = dirs[:, None].expand(n, T, r, 3).reshape(n, T * r, 3)
    out = decoder(feats, dirs_b)
    colors = out["rgb"].reshape(n, T, r, -1)
    sigmas = out["sigma"].reshape(n, T, r)
    depths = t_vals[:, :, None] * dnorm[:, None, :]
    acc_rgb, acc_d, acc_w = composite(colors, sigmas, depths)
    return finalize(acc_rgb, acc_d, acc_w, t_vals, dnorm, opts)
