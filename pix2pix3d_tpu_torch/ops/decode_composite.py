"""Fused decode + composite of the frustum renderer: wrapper and plain
PyTorch version.

Port of `pix2pix3d_tpu/ops/render_pallas.py::fused_decode_composite`.  The
kernel is `csrc/decode_composite.cu` (CUDA C++ for sm_90a), built by
`ops/cuda_build.py` into a shared library with a plain C interface on first
use and loaded with `ctypes`.  Layout, as the TPU kernel takes it:

    feats   [CH, N, TC, 32, R]  slab features, channels first, f32 or bf16
    t_vals  [N, CH*TC] f32      z-depths;  dnorm [N, R] f32 direction norms
    w1t [128, 32], b1 [128, 1], w2t [128, 128], b2 [128, 1]
    -> acc_rgb [N, 64, R], acc_d [N, R], acc_w [N, R]   (f32, unnormalized)

The weights are those of `fuse_late_separate_params_t`: the kernel and the
plain version read only W2ᵀ's two live blocks, W2ᵀ[0:32, 0:64] (rgb) and
W2ᵀ[32:65, 64:128] (semantic features and sigma).

`fused_decode_composite` launches the kernel for CUDA tensors and runs
`decode_composite_plain` for CPU tensors; there is no other fallback.  Each
launch adds one to `fused_decode_composite.launches`.  It has no backward
(nor has the TPU kernel): with grad mode on, an input that requires grad
raises on every device (`cuda_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .bias_act import softplus

NAME = "decode_composite"   # csrc/decode_composite.cu


@torch.no_grad()
def fuse_late_separate_params(decoder, lr_mul):
    """Merge the lateSeparate decoder's two MLPs into (W1 [32,128],
    b1 [1,128], W2 [128,128], b2 [1,128]); port of
    `pix2pix3d_tpu/ops/decoder_pallas.py::fuse_late_separate_params`.

    W2 is block-diagonal: rows 0:64 of the hidden layer feed the rgb
    features (cols 0:32), rows 64:128 the semantic features (cols 32:64)
    and sigma (col 64); every other entry is 0, and the kernels and their
    plain versions read only those two blocks.  Gains follow
    `FullyConnected`."""
    for net in (decoder.net, decoder.net_semantic):
        if tuple(net.fc0.weight.shape) != (64, 32) or \
                tuple(net.fc1.weight.shape) != (33, 64):
            raise ValueError("the fused decoder packs the 32 -> 64 -> 33 "
                             "lateSeparate topology only")

    def g(fc, fan_in):
        return (fc.weight.float().t() * (lr_mul / math.sqrt(fan_in)),
                fc.bias.float() * lr_mul)

    wa0, ba0 = g(decoder.net.fc0, 32.0)
    wb0, bb0 = g(decoder.net_semantic.fc0, 32.0)
    wa1, ba1 = g(decoder.net.fc1, 64.0)
    wb1, bb1 = g(decoder.net_semantic.fc1, 64.0)
    dev = wa0.device
    w1 = torch.cat([wa0, wb0], dim=1)                       # [32, 128]
    b1 = torch.cat([ba0, bb0])[None, :]                     # [1, 128]
    w2 = torch.zeros((128, 128), device=dev)
    w2[:64, 0:32] = wa1[:, 1:33]
    w2[64:, 32:64] = wb1[:, 1:33]
    w2[64:, 64] = wb1[:, 0]
    b2 = torch.zeros((128,), device=dev)
    b2[0:32] = ba1[1:33]
    b2[32:64] = bb1[1:33]
    b2[64] = bb1[0]
    return w1, b1, w2, b2[None, :]


def fuse_late_separate_params_t(decoder, lr_mul):
    """Transposed fused params (W1t [128,32], b1 [128,1], W2t [128,128],
    b2 [128,1]) for the rays-last kernel layout (`render_pallas.py:48`)."""
    w1, b1, w2, b2 = fuse_late_separate_params(decoder, lr_mul)
    return (w1.t().contiguous(), b1.reshape(-1, 1), w2.t().contiguous(),
            b2.reshape(-1, 1))


def decode_composite_plain(feats, t_vals, dnorm, w1t, b1, w2t, b2,
                           sem_sigmoid=False, carry_f32=False):
    """Plain PyTorch version of the kernel: same math, same roundings.

    Products are taken in f32 on inputs rounded to the feats type, which is
    what bf16-in / f32-accumulate hardware computes; h (and, without
    `carry_f32`, the colors) are rounded to the feats type where the TPU
    kernel casts them.  Only W2ᵀ's two live blocks are read,
    W2ᵀ[0:32, 0:64] and W2ᵀ[32:65, 64:128] (the packing of
    `fuse_late_separate_params_t`); the rest of W2ᵀ is never looked at."""
    CH, N, TC, C, R = feats.shape
    dt = feats.dtype
    w1 = w1t.to(dt).float()
    w2_rgb = w2t[:32, :64].to(dt).float()
    w2_sem = w2t[32:65, 64:].to(dt).float()
    b1 = b1.float().reshape(-1, 1)
    b2 = b2.float().reshape(-1, 1)
    rows = torch.arange(65, device=feats.device)[:, None]
    use = (rows < 32) | ((rows < 64) & sem_sigmoid)

    prev_c = prev_s = prev_d = trans = acc_c = acc_d = acc_w = None
    for t in range(CH * TC):
        x = feats[t // TC, :, t % TC].float()                 # [N, 32, R]
        h = softplus(torch.matmul(w1, x) + b1)                # [N, 128, R]
        h = h.to(dt).float()
        o = torch.cat([torch.matmul(w2_rgb, h[:, :64]),
                       torch.matmul(w2_sem, h[:, 64:])], dim=1) + b2[:65]
        o_act = torch.where(use, torch.sigmoid(o) * (1 + 2 * 0.001) - 0.001, o)
        c = o_act[:, :64]
        if not carry_f32:
            c = c.to(dt).float()
        s = o[:, 64]                                          # [N, R]
        d = t_vals[:, t, None] * dnorm                        # [N, R]
        if t == 0:
            prev_c, prev_s, prev_d = c, s, d
            trans = torch.ones_like(s)
            acc_c = torch.zeros_like(c)
            acc_d = torch.zeros_like(s)
            acc_w = torch.zeros_like(s)
            continue
        delta = d - prev_d
        sig_mid = softplus((prev_s + s) * 0.5 - 1.0)
        alpha = 1.0 - torch.exp(-sig_mid * delta)
        w = alpha * trans
        half_w = 0.5 * w
        acc_c = acc_c + half_w[:, None] * (prev_c + c)
        acc_d = acc_d + half_w * (prev_d + d)
        acc_w = acc_w + w
        trans = trans * (1.0 - alpha + 1e-10)
        prev_c, prev_s, prev_d = c, s, d
    return acc_c, acc_d, acc_w


class _FusedDecodeComposite:
    """Callable wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            self._fn = cuda_build.load(
                NAME, "p2p3d_decode_composite",
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        return self._fn

    def __call__(self, feats, t_vals, dnorm, w1t, b1, w2t, b2,
                 sem_sigmoid=False, carry_f32=False):
        """See the module docstring.  The compute type is feats' dtype
        (float32 or bfloat16); the weights are cast to it."""
        cuda_build.refuse_autograd("fused_decode_composite", feats, t_vals, dnorm,
                                   w1t, b1, w2t, b2)
        if feats.ndim != 5:
            raise ValueError(f"feats must be [CH, N, TC, 32, R], got "
                             f"{tuple(feats.shape)}")
        CH, N, TC, C, R = feats.shape
        T = CH * TC
        if feats.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"feats dtype {feats.dtype} is not float32/bfloat16")
        expect = {"t_vals": (t_vals, (N, T)), "dnorm": (dnorm, (N, R)),
                  "w1t": (w1t, (128, 32)), "b1": (b1, (128, 1)),
                  "w2t": (w2t, (128, 128)), "b2": (b2, (128, 1))}
        if C != 32:
            raise ValueError(f"feats has {C} channels, the decoder takes 32")
        for name, (a, shape) in expect.items():
            if tuple(a.shape) != shape:
                raise ValueError(f"{name} {tuple(a.shape)} != {shape}")
            if a.device != feats.device:
                raise ValueError(f"{name} on {a.device}, feats on {feats.device}")
        for name in ("t_vals", "dnorm"):
            if expect[name][0].dtype != torch.float32:
                raise TypeError(f"{name} must be float32")

        if feats.device.type == "cpu":
            return decode_composite_plain(feats, t_vals, dnorm, w1t, b1, w2t, b2,
                                          sem_sigmoid=sem_sigmoid,
                                          carry_f32=carry_f32)
        if feats.device.type != "cuda":
            raise ValueError(f"no kernel for device {feats.device}")
        if torch.cuda.get_device_capability(feats.device) != (9, 0):
            raise RuntimeError("the decode+composite kernel is built for sm_90a "
                               "(Hopper); this device is "
                               f"{torch.cuda.get_device_name(feats.device)}")
        for name, a in (("feats", feats), ("t_vals", t_vals), ("dnorm", dnorm)):
            if not a.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        dt = feats.dtype
        w1t = w1t.to(dt).contiguous()
        w2t = w2t.to(dt).contiguous()
        b1 = b1.float().contiguous()
        b2 = b2.float().contiguous()
        acc_rgb = torch.empty((N, 64, R), dtype=torch.float32, device=feats.device)
        acc_d = torch.empty((N, R), dtype=torch.float32, device=feats.device)
        acc_w = torch.empty((N, R), dtype=torch.float32, device=feats.device)
        fn = self._load()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream(feats.device).cuda_stream
            err = fn(feats.data_ptr(), t_vals.data_ptr(), dnorm.data_ptr(),
                     w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                     acc_rgb.data_ptr(), acc_d.data_ptr(), acc_w.data_ptr(),
                     CH, N, TC, R, int(dt == torch.bfloat16),
                     int(bool(sem_sigmoid)), int(bool(carry_f32)), stream)
        if err != 0:
            raise RuntimeError(f"decode_composite kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return acc_rgb, acc_d, acc_w


fused_decode_composite = _FusedDecodeComposite()
