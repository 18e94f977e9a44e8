"""Equivariance metrics EQ-T, EQ-T_frac and EQ-R of alias-free generators,
port of `pix2pix3d_tpu/metrics/equivariance.py` (ref `metrics/equivariance.py`,
StyleGAN3 paper, Appendix E.3).

The metric renders each latent twice: with the identity input transform, and
with the input transform set to the inverse of a random translation or
rotation; the masked PSNR between the transformed first render and the
second measures how equivariant the generator is.

The input transform is the `transform` buffer of the port's
`GeneratorS3.synthesis.input`, set for each render and restored after it
(on error too).  The image operators run as torch ops on the metric's device
in float64, as the JAX package runs them in numpy on the host, and return
float32: windowed-sinc translation, the jointly band-limited filter of an
affine warp (FFTs), the 4x zero-stuffed upsampling (a transposed
convolution), bilinear sampling with zeros padding and the mask's nearest
sampling (`torch.round`, half to even as `np.rint`).  Images are NCHW.
z is drawn from `np.random.RandomState(opts.rng_seed)` as the JAX package
draws it, so both packages score the same latents.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import precision

F64 = torch.float64


# ------------------------------------------------------------- primitives
def _sinc(x):
    y = (x * math.pi).abs()
    return torch.where(y < 1e-30, torch.ones_like(y),
                       torch.sin(y) / y.clamp_min(1e-30))


def _lanczos_window(x, a):
    x = x.abs() / a
    return torch.where(x < 1, _sinc(x), torch.zeros_like(x))


def rotation_matrix(angle):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, s, -s, c
    return m


def _depthwise(x, f):
    """Correlate every channel of NCHW `x` with the 2-D filter `f`, valid
    windows only."""
    n, c, h, w = x.shape
    y = F.conv2d(x.reshape(n * c, 1, h, w), f[None, None])
    return y.reshape(n, c, *y.shape[2:])


# ------------------------------------------- translation operators (E.2)
def apply_integer_translation(x, tx, ty):
    """x `[N, C, H, W]`; tx/ty in image-size units -> (shifted, mask)."""
    n, c, h, w = x.shape
    ix, iy = int(np.rint(tx * w)), int(np.rint(ty * h))
    z = torch.zeros_like(x)
    m = torch.zeros_like(x)
    if abs(ix) < w and abs(iy) < h:
        src = x[:, :, max(-iy, 0):h + min(-iy, 0), max(-ix, 0):w + min(-ix, 0)]
        z[:, :, max(iy, 0):h + min(iy, 0), max(ix, 0):w + min(ix, 0)] = src
        m[:, :, max(iy, 0):h + min(iy, 0), max(ix, 0):w + min(ix, 0)] = 1
    return z, m


def apply_fractional_translation(x, tx, ty, a=3):
    """Windowed-sinc subpixel translation (ref `equivariance.py:49-80`)."""
    n, c, h, w = x.shape
    tx, ty = float(tx * w), float(ty * h)
    ix, iy = int(np.floor(tx)), int(np.floor(ty))
    fx, fy = tx - ix, ty - iy
    b = a - 1

    z = torch.zeros_like(x)
    zx0, zy0 = max(ix - b, 0), max(iy - b, 0)
    zx1, zy1 = min(ix + a, 0) + w, min(iy + a, 0) + h
    if zx0 < zx1 and zy0 < zy1:
        taps = torch.arange(a * 2, dtype=F64, device=x.device) - b
        filt_x = _sinc(taps - fx) * _sinc((taps - fx) / a)
        filt_y = _sinc(taps - fy) * _sinc((taps - fy) / a)
        filt_x = filt_x / filt_x.sum()
        filt_y = filt_y / filt_y.sum()
        # padding a+b on each side, then a true convolution (the flipped
        # taps, correlated) over valid windows: length + a + b on each axis
        y = F.pad(x.to(F64), [a + b, a + b, 0, 0])
        y = _depthwise(y, filt_x.flip(0)[None])
        y = F.pad(y, [0, 0, a + b, a + b])
        y = _depthwise(y, filt_y.flip(0)[:, None])
        y = y[:, :, max(b - iy, 0):h + b + a + min(-iy - a, 0),
              max(b - ix, 0):w + b + a + min(-ix - a, 0)]
        z[:, :, zy0:zy1, zx0:zx1] = y.to(x.dtype)

    m = torch.zeros_like(x)
    mx0, my0 = max(ix + a, 0), max(iy + a, 0)
    mx1, my1 = min(ix - b, 0) + w, min(iy - b, 0) + h
    if mx0 < mx1 and my0 < my1:
        m[:, :, my0:my1, mx0:mx1] = 1
    return z, m


# ---------------------------------------------- rotation operators (E.3)
def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4,
                                      cutoff_in=1, cutoff_out=1, device="cpu"):
    """Jointly band-limited resampling filter of an affine warp (ref
    `equivariance.py:86-132`): the product of Lanczos-windowed sincs in the
    input and output frames, combined through FFTs in float64.  float32
    `[amax*2*up - 1, amax*2*up - 1]` on `device`, as the JAX package
    returns it."""
    assert a <= amax < aflt
    mat = torch.as_tensor(np.asarray(mat, np.float64), device=device)

    taps = (torch.arange(aflt * up * 2 - 1, dtype=F64, device=device) + 1) / up - aflt
    taps = torch.roll(taps, 1 - aflt * up)
    yi, xi = torch.meshgrid(taps, taps, indexing="ij")
    oc = torch.stack([xi, yi], dim=2) @ mat[:2, :2].T
    xo, yo = oc[..., 0], oc[..., 1]

    fi = _sinc(xi * cutoff_in) * _sinc(yi * cutoff_in)
    fo = _sinc(xo * cutoff_out) * _sinc(yo * cutoff_out)
    f = torch.fft.ifftn(torch.fft.fftn(fi) * torch.fft.fftn(fo)).real
    wi = _lanczos_window(xi, a) * _lanczos_window(yi, a)
    wo = _lanczos_window(xo, a) * _lanczos_window(yo, a)
    f = f * torch.fft.ifftn(torch.fft.fftn(wi) * torch.fft.fftn(wo)).real

    c = (aflt - amax) * up
    f = torch.roll(f, [aflt * up - 1] * 2, dims=(0, 1))[c:-c, c:-c]
    f = F.pad(f, [0, 1, 0, 1]).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(dim=(0, 2), keepdim=True) / (up ** 2)
    return f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1].float()


def _upsample2d(x, f, up, p):
    """Zero-stuffed upsampling by `up` and a true convolution with the
    square filter `f`, output `h*up + 2p` per axis (ref upfirdn2d.upsample2d
    with padding p).  A transposed convolution with stride `up` skips the
    stuffed zeros; its output is shifted by `F - 1 - p0` against the padded
    convolution (p0 = p + (F+up-1)//2, the low padding)."""
    n, c, h, w = x.shape
    taps = f.shape[0]
    y = F.conv_transpose2d(x.reshape(n * c, 1, h, w) * (up ** 2), f[None, None],
                           stride=up)
    d = taps - 1 - (p + (taps + up - 1) // 2)
    size = h * up + 2 * p, w * up + 2 * p
    y = F.pad(y, [-d, d + size[1] - y.shape[3], -d, d + size[0] - y.shape[2]])
    return y.reshape(n, c, *size)


def _affine_grid(theta, h, w, device):
    """affine_grid(align_corners=False): each output pixel's center mapped
    through `theta` [2, 3] -> `[H, W, 2]` float64 (x, y) in [-1, 1]."""
    theta = torch.as_tensor(theta, dtype=F64, device=device)
    gy, gx = torch.meshgrid(
        (torch.arange(h, dtype=F64, device=device) + 0.5) / h * 2 - 1,
        (torch.arange(w, dtype=F64, device=device) + 0.5) / w * 2 - 1,
        indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return pts @ theta.T


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """Band-limited affine warp (ref `equivariance.py:137-166`): (warped,
    mask), both `[N, C, H, W]`."""
    n, c, h, w = x.shape
    mat = np.asarray(mat, np.float64)
    f = construct_affine_bandlimit_filter(mat, up=up, device=x.device,
                                          **filter_kwargs)
    p = f.shape[0] // 2

    theta = np.linalg.inv(mat)
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / w
    theta[1, 2] += 1 / up / h
    theta[0, :] *= w / (w + p / up * 2)
    theta[1, :] *= h / (h + p / up * 2)
    grid = _affine_grid(theta[:2, :3], h, w, x.device)          # [H, W, 2]

    y = _upsample2d(x.to(F64), f.to(F64), up, p)
    z = F.grid_sample(y, grid[None].expand(n, h, w, 2), mode="bilinear",
                      padding_mode="zeros", align_corners=False)

    # the mask: ones at least 2p+1 texels inside the upsampled image,
    # nearest-sampled (half to even, as np.rint)
    hy, wy = y.shape[2:]
    cc = p * 2 + 1
    ix = torch.round((grid[..., 0] + 1) * (wy / 2) - 0.5)
    iy = torch.round((grid[..., 1] + 1) * (hy / 2) - 0.5)
    inside = (ix >= cc) & (ix < wy - cc) & (iy >= cc) & (iy < hy - cc)
    m = inside.to(x.dtype)[None, None].expand(n, c, h, w)
    return z.to(x.dtype), m


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    return apply_affine_transformation(x, rotation_matrix(angle), a=a,
                                       amax=a * 2, **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R*_alpha: the rotated image's frequency content without rotating
    (ref `equivariance.py:176-185`)."""
    f = construct_affine_bandlimit_filter(rotation_matrix(-angle), a=a,
                                          amax=a * 2, up=1, device=x.device,
                                          **filter_kwargs)
    p = f.shape[0] // 2
    y = _depthwise(F.pad(x.to(F64), [p, p, p, p]), f.to(F64).flip((0, 1)))
    m = torch.zeros_like(x)
    m[:, :, p:-p, p:-p] = 1
    return y.to(x.dtype), m


# ---------------------------------------------------------------- metric
@contextlib.contextmanager
def input_transform(G, mat):
    """Set `G.synthesis.input.transform` to `mat` for the block, restoring
    the old value after it (on error too)."""
    buf = G.synthesis.input.transform
    old = buf.clone()
    buf.copy_(torch.as_tensor(np.asarray(mat), dtype=buf.dtype))
    try:
        yield
    finally:
        buf.copy_(old)


@torch.no_grad()
@precision.policy(False)
def compute_equivariance_metrics(opts, num_samples=200, batch_size=4,
                                 translate_max=0.125, rotate_max=1.0,
                                 compute_eqt_int=False, compute_eqt_frac=False,
                                 compute_eqr=False):
    """Masked-PSNR equivariance scores (ref `equivariance.py:190-270`) of
    `opts.G`, the port's `GeneratorS3` on `opts.device`; f32 with TF32 off,
    as the JAX package's f32 programs run at HIGHEST."""
    assert compute_eqt_int or compute_eqt_frac or compute_eqr
    G, dev = opts.G, opts.device
    synthesis_input = getattr(getattr(G, "synthesis", None), "input", None)
    if not hasattr(synthesis_input, "transform"):
        raise ValueError("generator has no input transform; equivariance "
                         "metrics need an alias-free (StyleGAN3) generator")
    rng = np.random.RandomState(opts.rng_seed)
    I = np.eye(3, dtype=np.float32)

    def render(mat, z, c):
        with input_transform(G, mat):
            return G(z, c, noise_mode="const")

    sums = torch.zeros(6, dtype=F64, device=dev)

    def add(i, ref, img, mask):
        sums[i] += ((ref - img).square() * mask).to(F64).sum()
        sums[i + 1] += mask.to(F64).sum()

    for _ in range(0, num_samples, batch_size):
        z = torch.from_numpy(rng.randn(batch_size, G.z_dim).astype(np.float32)).to(dev)
        c = torch.zeros((batch_size, G.c_dim), device=dev)
        orig = render(I, z, c)

        if compute_eqt_int:
            t = (rng.rand(2) * 2 - 1) * translate_max
            t = np.rint(t * G.img_resolution) / G.img_resolution
            m = I.copy()
            m[:2, 2] = -t
            img = render(m, z, c)
            ref, mask = apply_integer_translation(orig, t[0], t[1])
            add(0, ref, img, mask)

        if compute_eqt_frac:
            t = (rng.rand(2) * 2 - 1) * translate_max
            m = I.copy()
            m[:2, 2] = -t
            img = render(m, z, c)
            ref, mask = apply_fractional_translation(orig, t[0], t[1])
            add(2, ref, img, mask)

        if compute_eqr:
            angle = (rng.rand() * 2 - 1) * (rotate_max * np.pi)
            img = render(rotation_matrix(-angle), z, c)
            ref, ref_mask = apply_fractional_rotation(orig, angle)
            pseudo, pseudo_mask = apply_fractional_pseudo_rotation(img, angle)
            add(4, ref, pseudo, ref_mask * pseudo_mask)

    sums = sums.cpu().numpy()

    # PSNR on the [-1, 1] range (peak-to-peak 2 -> 20*log10(2/rmse))
    def psnr(se, n_):
        mse = se / max(n_, 1e-12)
        return float(10 * np.log10(4 / max(mse, 1e-20)))

    out = {}
    if compute_eqt_int:
        out["eqt_int"] = psnr(sums[0], sums[1])
    if compute_eqt_frac:
        out["eqt_frac"] = psnr(sums[2], sums[3])
    if compute_eqr:
        out["eqr"] = psnr(sums[4], sums[5])
    return out
