"""Both texture-side shears of the frustum render for every image and plane
at once: wrapper and plain PyTorch version.

The kernel is `csrc/shear_textures.cu` (CUDA C++ for sm_90a), built by
`ops/cuda_build.py` into a shared library with a plain C interface on first
use and loaded with `ctypes`.  It has no Pallas counterpart: the JAX package
shears with plain XLA (`pix2pix3d_tpu/render/frustum.py` `shear_texture`,
vmapped in `prepare_textures`).  Layout:

    planes  [N, q, S, S, C]  f32 or bf16, any strides (the render hands it
                             the backbone's [N, q*C, S, S] memory permuted:
                             channel-planar, x contiguous)
    a, b    [N, q] f32       the shear slopes of `factor_shears`
    flip    [N, q] bool      transpose the plane first
    -> [N*q, ext, C, ext] in `compute_dtype`, ext = S + 2*MARGIN:
    out[k, p, c, o] = sum_y w(y - (p - M + b_k (o - M)))
                      * sum_x w(x - (o - M + a_k y)) * tex_k[y, x, c]

with w the Catmull-Rom taps of `_cubic_weights`, zeros outside the texture,
M = MARGIN, and tex_k plane k % q of image k // q (transposed where flip is
set).  The kernel takes its taps and sums in f32 and rounds the output once.
The plain version, `shear_textures_plain`, is JAX's: per texture
(`shear_texture`), two dense band-matrix products (`shear_pass`).

`shear_textures` launches the kernel for CUDA tensors and runs
`shear_textures_plain` for CPU tensors; there is no other fallback.  Each
launch adds one to `shear_textures.launches`.  It has no backward: with grad
mode on, an input that requires grad raises on every device
(`cuda_build.refuse_autograd`); the render calls the differentiable
`shear_textures_plain` for that case.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NAME = "shear_textures"   # csrc/shear_textures.cu

# static shear margin (texels); |a|,|b| <= MARGIN/S is the supported range
MARGIN = 128


def _cubic_weights(centers, in_len, dtype=torch.float32):
    """Catmull-Rom taps W[..., o, x] = w(x - c(o)); rows whose center lies
    outside the input come out all-zero (zeros padding)."""
    x = torch.arange(in_len, dtype=torch.float32, device=centers.device)
    d = (x - centers[..., None]).abs()
    w_near = (1.5 * d - 2.5) * d * d + 1.0
    w_far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    w = torch.where(d < 1.0, w_near, torch.where(d < 2.0, w_far, torch.zeros_like(d)))
    return w.to(dtype)


def shear_pass(tex, slope, out_len, margin, compute_dtype=torch.float32):
    """out[l, o, c] = tex sampled at (l, (o - margin) + slope*l), cubic taps
    and zeros padding.  tex [L, X, C] -> [L, out_len, C] (f32)."""
    L, X, C = tex.shape
    dev = tex.device
    lines = torch.arange(L, dtype=torch.float32, device=dev)
    centers = (torch.arange(out_len, dtype=torch.float32, device=dev)[None, :]
               - margin + slope * lines[:, None])
    W = _cubic_weights(centers, X, dtype=compute_dtype)
    return torch.bmm(W, tex.to(compute_dtype)).float()


def shear_texture(tex, a, b, compute_dtype=torch.float32):
    """Both texture-side shears of one texture, the plain version of the
    kernel (band matrices in compute_dtype, products in it, f32 result):
    [S, S, C] -> [S+2M, S+2M, C] covering the extended [-MARGIN, S+MARGIN)
    range on both axes."""
    S = tex.shape[0]
    ext = S + 2 * MARGIN
    dev = tex.device
    t1 = shear_pass(tex, a, ext, MARGIN, compute_dtype)        # [S, ext, C]
    t1t = t1.transpose(0, 1)                                   # [ext, S, C]
    lines_off = torch.arange(ext, dtype=torch.float32, device=dev) - MARGIN
    centers = (torch.arange(ext, dtype=torch.float32, device=dev)[None, :]
               - MARGIN + b * lines_off[:, None])
    W = _cubic_weights(centers, S, dtype=compute_dtype)
    t2t = torch.bmm(W, t1t.to(compute_dtype)).float()          # [ext_x, ext_y, C]
    return t2t.transpose(0, 1)


def shear_textures_plain(planes, a, b, flip, compute_dtype=torch.float32):
    """`shear_texture` of every texture, stacked as [N*q, ext, C, ext]
    (f32); differentiable."""
    n, q, S, _, c = planes.shape
    tex = planes.reshape(n * q, S, S, c)
    tex = torch.where(flip.reshape(n * q)[:, None, None, None], tex.transpose(1, 2), tex)
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.stack([shear_texture(tex[i], a[i], b[i], compute_dtype).transpose(1, 2)
                        for i in range(n * q)])


class _ShearTextures:
    """Callable wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            self._fn = cuda_build.load(
                NAME, "p2p3d_shear_textures",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 5
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        return self._fn

    def __call__(self, planes, a, b, flip, compute_dtype=torch.float32):
        """See the module docstring."""
        cuda_build.refuse_autograd("shear_textures", planes, a, b)
        if planes.ndim != 5 or planes.shape[2] != planes.shape[3]:
            raise ValueError(f"planes must be [N, q, S, S, C], got {tuple(planes.shape)}")
        n, q, S, _, c = planes.shape
        for name, t, dtype in (("a", a, torch.float32), ("b", b, torch.float32),
                               ("flip", flip, torch.bool)):
            if tuple(t.shape) != (n, q):
                raise ValueError(f"{name} {tuple(t.shape)} != {(n, q)}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if t.device != planes.device:
                raise ValueError(f"{name} on {t.device}, planes on {planes.device}")
        for name, dtype in (("planes", planes.dtype), ("compute_dtype", compute_dtype)):
            if dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{name} {dtype} is not float32/bfloat16")

        if planes.device.type == "cpu":
            return shear_textures_plain(planes, a, b, flip, compute_dtype).to(compute_dtype)
        if planes.device.type != "cuda":
            raise ValueError(f"no kernel for device {planes.device}")
        if torch.cuda.get_device_capability(planes.device) != (9, 0):
            raise RuntimeError("the shear kernel is built for sm_90a (Hopper); this "
                               f"device is {torch.cuda.get_device_name(planes.device)}")
        ext = S + 2 * MARGIN
        out = torch.empty((n * q, ext, c, ext), dtype=compute_dtype, device=planes.device)
        a, b, flip = a.contiguous(), b.contiguous(), flip.contiguous()
        fn = self._load()
        with torch.cuda.device(planes.device):
            stream = torch.cuda.current_stream(planes.device).cuda_stream
            err = fn(planes.data_ptr(), a.data_ptr(), b.data_ptr(), flip.data_ptr(),
                     out.data_ptr(), n * q, q, S, c, *planes.stride(),
                     int(planes.dtype == torch.bfloat16),
                     int(compute_dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"shear_textures kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


shear_textures = _ShearTextures()
