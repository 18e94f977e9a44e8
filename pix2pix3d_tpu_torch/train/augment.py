"""ADA augmentation pipeline, port of `pix2pix3d_tpu/train/augment.py` (ref
`training/augment.py`).

The reference's augmentation menu and probability semantics (StyleGAN2-ADA):
each augmentation fires per image with probability `p * strength`.  The
geometric ones compose into one inverse 3x3 affine matrix per image, applied
with one bilinear warp at native resolution (`ops/grid_sample.grid_sample_2d`,
zeros padding: a gather whose backward is differentiable again, which R1
needs; `F.grid_sample`'s backward has no double backward); the color ones
compose into one 4x4 matrix applied per pixel; then the frequency-band
filter, additive noise and cutout.  When nothing fires, the sample points
land on pixel centers and the color matrix is the identity, so the pipe
returns its input bit for bit (at power-of-two sizes, products in f32 with
TF32 off).

Images are `[N, H, W, C]` in [-1, 1], as in the JAX package: C = 3 (RGB),
1 (the luma row of the color matrix), or more than 3 (the image|raw pair of
the loss: the color matrix on each block of 3 channels, the rest passed
through).

Randomness: every draw goes through the hooks `draw_uniform`,
`draw_normal` and `draw_randint` on the `torch.Generator` the call is
given, in the order the JAX pipe draws from its split keys (`k_geom`,
`k_color`, `k_filt`, `k_noise`, `k_cut`, then the inner splits); each
gate and each parameter is its own draw.  The tests hand JAX's draws to
these hooks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import conv2d_gradfix
from ..ops.grid_sample import grid_sample_2d


def draw_uniform(generator, shape, device):
    """U[0, 1) draws from `generator` (on its own device), on `device`."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def draw_normal(generator, shape, device):
    """N(0, 1) draws from `generator` (on its own device), on `device`."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def draw_randint(generator, low, high, shape, device):
    """Integers in [low, high) from `generator`, as f32 on `device`."""
    return torch.randint(low, high, shape, generator=generator,
                         device=generator.device).to(device).float()


def _stack3(rows):
    """[[a, b, c], ...] of [N] tensors -> [N, 3, 3]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _translate2d(tx, ty):
    o, z = torch.ones_like(tx), torch.zeros_like(tx)
    return _stack3([[o, z, tx], [z, o, ty], [z, z, o]])


def _scale2d(sx, sy):
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack3([[sx, z, z], [z, sy, z], [z, z, o]])


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return _stack3([[c, -s, z], [s, c, z], [z, z, o]])


# Symlet-2 analysis lowpass taps (ref `training/augment.py:38,177-186`).
_SYM2 = np.array([-0.12940952255092145, 0.22414386804185735,
                  0.836516303737469, 0.48296291314469025])


def _make_freq_bank(num_bands=4):
    """4-band octave filter bank for imgfilter: band i isolates the octave
    below Nyquist/2^i (iterated a-trous lowpass plus one highpass
    injection, ref `augment.py:177-186`), numpy, `[bands, taps]` f32."""
    lo = _SYM2
    hi = lo * ((-1.0) ** np.arange(lo.size))
    lo2 = np.convolve(lo, lo[::-1]) / 2
    hi2 = np.convolve(hi, hi[::-1]) / 2
    bank = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        up = np.zeros((num_bands, bank.shape[1] * 2 - 1))
        up[:, ::2] = bank
        bank = np.stack([np.convolve(row, lo2) for row in up])
        lo_idx = (bank.shape[1] - hi2.size) // 2
        bank[i, lo_idx:lo_idx + hi2.size] += hi2
    return bank.astype(np.float32)


def _reflect_pad(x, pad):
    """Reflect padding of the last two dims of NCHW `x` by `pad` (numpy's
    'reflect', repeated where `pad` exceeds the size), as slices, flips and
    concatenations: a backward without atomics, so a step stays repeatable
    under deterministic algorithms."""
    def one(x, dim):
        left = pad
        while left > 0:
            n = x.shape[dim]
            k = min(left, n - 1)
            x = torch.cat([x.narrow(dim, 1, k).flip(dim), x,
                           x.narrow(dim, n - 1 - k, k).flip(dim)], dim=dim)
            left -= k
        return x
    return one(one(x, 2), 3)


class AugmentPipe:
    """Probability-gated augmentation pipeline.  The arguments are the
    reference constructor's: per-category strengths (0 = off, 1 = standard
    ADA) and the parameters' spreads."""

    def __init__(self, xflip=0, rotate90=0, xint=0, xint_max=0.125,
                 scale=0, rotate=0, aniso=0, xfrac=0, scale_std=0.2,
                 rotate_max=1.0, aniso_std=0.2, xfrac_std=0.125,
                 brightness=0, contrast=0, lumaflip=0, hue=0, saturation=0,
                 brightness_std=0.2, contrast_std=0.5, hue_max=1.0,
                 saturation_std=1.0,
                 imgfilter=0, imgfilter_bands=(1, 1, 1, 1), imgfilter_std=1.0,
                 noise=0, cutout=0, noise_std=0.1, cutout_size=0.5):
        self.xflip = xflip
        self.rotate90 = rotate90
        self.xint = xint
        self.xint_max = xint_max
        self.scale = scale
        self.rotate = rotate
        self.aniso = aniso
        self.xfrac = xfrac
        self.scale_std = scale_std
        self.rotate_max = rotate_max
        self.aniso_std = aniso_std
        self.xfrac_std = xfrac_std
        self.brightness = brightness
        self.contrast = contrast
        self.lumaflip = lumaflip
        self.hue = hue
        self.saturation = saturation
        self.brightness_std = brightness_std
        self.contrast_std = contrast_std
        self.hue_max = hue_max
        self.saturation_std = saturation_std
        self.imgfilter = imgfilter
        self.imgfilter_bands = list(imgfilter_bands)
        self.imgfilter_std = imgfilter_std
        self.noise = noise
        self.cutout = cutout
        self.noise_std = noise_std
        self.cutout_size = cutout_size
        self.Hz_fbank = torch.from_numpy(_make_freq_bank()) if imgfilter > 0 else None

    def _geom_matrix(self, gen, n, p, dev):
        """Per-image inverse affine `[N, 3, 3]` in normalized [-1, 1]
        coordinates; each parameter and each gate its own draw."""
        eye = torch.eye(3, device=dev)
        G = eye.expand(n, 3, 3)

        def apply(G, mat, prob_scale):
            gate = draw_uniform(gen, (n,), dev) < p * prob_scale
            return G @ torch.where(gate[:, None, None], mat, eye)

        if self.xflip > 0:
            flip = torch.where(draw_uniform(gen, (n,), dev) < 0.5, -1.0, 1.0)
            G = apply(G, _scale2d(flip, torch.ones(n, device=dev)), self.xflip)
        if self.rotate90 > 0:
            k = draw_randint(gen, 0, 4, (n,), dev)
            G = apply(G, _rotate2d(-(math.pi / 2) * k), self.rotate90)
        if self.xint > 0:
            t = (draw_uniform(gen, (n, 2), dev) * 2 - 1) * self.xint_max
            G = apply(G, _translate2d(t[:, 0], t[:, 1]), self.xint)
        if self.scale > 0:
            s = torch.exp2(draw_normal(gen, (n,), dev) * self.scale_std)
            G = apply(G, _scale2d(s, s), self.scale)
        if self.rotate > 0:
            theta = (draw_uniform(gen, (n,), dev) * 2 - 1) * math.pi * self.rotate_max
            G = apply(G, _rotate2d(-theta), self.rotate)
        if self.aniso > 0:
            s = torch.exp2(draw_normal(gen, (n,), dev) * self.aniso_std)
            G = apply(G, _scale2d(s, 1 / s), self.aniso)
        if self.xfrac > 0:
            t = draw_normal(gen, (n, 2), dev) * self.xfrac_std
            G = apply(G, _translate2d(t[:, 0], t[:, 1]), self.xfrac)
        return G

    def _color_matrix(self, gen, n, p, num_channels, dev):
        """Per-image 4x4 color matrix `[N, 4, 4]` acting on (r, g, b, 1)."""
        eye = torch.eye(4, device=dev)
        C = eye.expand(n, 4, 4)
        v = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)  # luma axis

        def apply(C, mat, prob_scale):
            gate = draw_uniform(gen, (n,), dev) < p * prob_scale
            return torch.where(gate[:, None, None], mat, eye) @ C

        if self.brightness > 0:
            b = draw_normal(gen, (n,), dev) * self.brightness_std
            m = eye.repeat(n, 1, 1)
            m[:, :3, 3] = b[:, None]
            C = apply(C, m, self.brightness)
        if self.contrast > 0:
            c = torch.exp2(draw_normal(gen, (n,), dev) * self.contrast_std)
            m = eye.repeat(n, 1, 1)
            for i in range(3):
                m[:, i, i] = c
            C = apply(C, m, self.contrast)
        if self.lumaflip > 0:
            m = (eye - 2 * torch.outer(v, v)).expand(n, 4, 4)  # householder about luma
            C = apply(C, m, self.lumaflip)
        if self.hue > 0 and num_channels > 1:
            theta = (draw_uniform(gen, (n,), dev) * 2 - 1) * math.pi * self.hue_max
            # Rodrigues rotation about the unit luma axis (ref rotate3d,
            # `augment.py:96-105`)
            K = torch.tensor([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                              [-v[1], v[0], 0.0]], device=dev)
            c = torch.cos(theta)[:, None, None]
            s = torch.sin(theta)[:, None, None]
            R3 = (torch.eye(3, device=dev) * c + K * s
                  + (1 - c) * torch.outer(v[:3], v[:3]))
            m = eye.repeat(n, 1, 1)
            m[:, :3, :3] = R3
            C = apply(C, m, self.hue)
        if self.saturation > 0 and num_channels > 1:
            s = torch.exp2(draw_normal(gen, (n,), dev) * self.saturation_std)
            outer = torch.outer(v, v)
            m = outer + (eye - outer) * s[:, None, None]
            C = apply(C, m, self.saturation)
        return C

    def _imgfilter(self, gen, images, p):
        """Per-band frequency amplification (ref `augment.py:382-409`): each
        of 4 octave bands is amplified by exp2(N(0, std)) with probability
        p * imgfilter * band strength, the gains are power-normalized
        against a 1/f prior, and the combined separable filter runs as two
        depthwise convolutions (one group per image and channel, through
        `ops/conv2d_gradfix`) after reflect padding."""
        n, h, w, c = images.shape
        dev = images.device
        bank = self.Hz_fbank.to(dev)                          # [bands, taps]
        num_bands, taps = bank.shape
        expected_power = torch.tensor([10.0, 1.0, 1.0, 1.0], device=dev) / 13
        g = torch.ones((n, num_bands), device=dev)
        for i, band_strength in enumerate(self.imgfilter_bands):
            t_i = torch.exp2(draw_normal(gen, (n,), dev) * self.imgfilter_std)
            gate = draw_uniform(gen, (n,), dev) < p * self.imgfilter * band_strength
            t = torch.ones((n, num_bands), device=dev)
            t[:, i] = torch.where(gate, t_i, 1.0)
            t = t / (expected_power * t.square()).sum(-1, keepdim=True).sqrt()
            g = g * t
        hz = g @ bank                                         # [n, taps]
        # one group per (image, channel), image-major as in the JAX package:
        # group k filters channel k % c of image k // c with that image's taps
        x = _reflect_pad(images.permute(0, 3, 1, 2).reshape(1, n * c, h, w),
                         taps // 2)
        wk = hz.repeat_interleave(c, dim=0)                   # [n*c, taps]
        x = conv2d_gradfix.conv2d(x, wk[:, None, :, None], groups=n * c)
        x = conv2d_gradfix.conv2d(x, wk[:, None, None, :], groups=n * c)
        return x.reshape(n, c, h, w).permute(0, 2, 3, 1)

    def __call__(self, images, p, generator):
        """`images` `[N, H, W, C]` in [-1, 1]; `p` a float or 0-d tensor in
        [0, 1]; every draw from `generator`."""
        n, h, w, c = images.shape
        dev = images.device
        gen = generator

        # geometric: one bilinear warp at native resolution
        G_inv = self._geom_matrix(gen, n, p, dev)
        yy, xx = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2 - 1,
            (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2 - 1,
            indexing="ij")
        grid = torch.stack([xx, yy, torch.ones_like(xx)], -1).reshape(-1, 3)
        warped = torch.einsum("nij,mj->nmi", G_inv, grid)[..., :2]
        out = grid_sample_2d(images, warped, padding_mode="zeros").reshape(n, h, w, c)

        # color
        C_mat = self._color_matrix(gen, n, p, c, dev)
        ones = torch.ones((n, h, w, 1), dtype=out.dtype, device=dev)
        if c == 3:
            out = torch.einsum("nij,nhwj->nhwi", C_mat,
                               torch.cat([out, ones], -1))[..., :3]
        elif c == 1:
            # grayscale: the luma row of the color matrix
            rgb1 = torch.cat([out.expand(n, h, w, 3), ones], -1)
            out = torch.einsum("nj,nhwj->nhw", C_mat[:, 0], rgb1)[..., None]
        else:
            # image|raw pair: each block of 3 channels, the rest passed through
            parts = [torch.einsum("nij,nhwj->nhwi", C_mat,
                                  torch.cat([out[..., s:s + 3], ones], -1))[..., :3]
                     for s in range(0, c - c % 3, 3)]
            if c % 3:
                parts.append(out[..., c - c % 3:])
            out = torch.cat(parts, -1)

        # image-space filtering (ref `augment.py:382-409`)
        if self.imgfilter > 0:
            out = self._imgfilter(gen, out, p)

        # image-space corruptions (ref `augment.py:415-433`)
        if self.noise > 0:
            sigma = draw_normal(gen, (n, 1, 1, 1), dev).abs() * self.noise_std
            gate = draw_uniform(gen, (n, 1, 1, 1), dev) < p * self.noise
            sigma = torch.where(gate, sigma, 0.0)
            out = out + draw_normal(gen, tuple(out.shape), dev) * sigma
        if self.cutout > 0:
            size = torch.where(draw_uniform(gen, (n, 1), dev) < p * self.cutout,
                               self.cutout_size, 0.0)        # [n, 1]
            center = draw_uniform(gen, (n, 2), dev)          # [n, 2] in [0, 1)
            cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            keep_x = (cx[None] - center[:, :1]).abs() >= size / 2  # [n, w]
            keep_y = (cy[None] - center[:, 1:]).abs() >= size / 2  # [n, h]
            mask = keep_y[:, :, None] | keep_x[:, None, :]
            out = out * mask[..., None].to(out.dtype)
        return out


def ada_update_p(p, signs_real_mean, batch_size, ada_interval=4, ada_kimg=500,
                 ada_target=0.6):
    """ADA heuristic (ref `training_loop.py:566-569`): move p so that
    E[sign(D(real))] stays at the target."""
    adjust = np.sign(signs_real_mean - ada_target) \
        * (batch_size * ada_interval) / (ada_kimg * 1000)
    return float(np.clip(p + adjust, 0, 1))
