"""The lateSeparate decoder's two MLPs and epilogue in one kernel: wrapper and
plain PyTorch version.

Port of `pix2pix3d_tpu/ops/decoder_pallas.py::late_separate_decode`.  The
kernel is `csrc/late_separate_decode.cu` (CUDA C++ for sm_90a), built by
`ops/cuda_build.py` and loaded with `ctypes`.  It takes the packed weights
of `ops/decode_composite.py::fuse_late_separate_params`, and reads only
W2's two live blocks, W2[0:64, 0:32] and W2[64:128, 32:65]:

    feats [M, 32], w1 [32, 128], b1 [1, 128], w2 [128, 128], b2 [1, 128]
    -> colors [M, 64] in the compute type, sigma [M, 1] f32

h = softplus(feats . w1 + b1) in f32, rounded to the compute type;
o = h . w2 + b2 in f32; the sigmoid clamp on cols 0:32 if `rgb_sigmoid` and
32:64 if `sem_sigmoid`; colors and sigma (col 64) rounded to the compute
type, sigma returned as f32.

`late_separate_decode` launches the kernel for CUDA tensors and runs
`late_separate_decode_plain` for CPU tensors; there is no other fallback.
Each launch adds one to `late_separate_decode.launches`.  It has no
backward (nor has the TPU kernel): with grad mode on, an input that
requires grad raises on every device (`cuda_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .bias_act import softplus

NAME = "late_separate_decode"   # csrc/late_separate_decode.cu
_DTYPES = (torch.float32, torch.bfloat16)


def late_separate_decode_plain(feats, w1, b1, w2, b2, rgb_sigmoid=True,
                               sem_sigmoid=False, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel: same math, same roundings.

    Products are taken in f32 on inputs rounded to the compute type, which
    is what bf16-in / f32-accumulate hardware computes.  Only W2's two live
    blocks are read, W2[0:64, 0:32] and W2[64:128, 32:65] (the packing of
    `fuse_late_separate_params`); the rest of W2 is never looked at."""
    cd = compute_dtype
    x = feats.to(cd).float()
    h = softplus(torch.matmul(x, w1.to(cd).float()) + b1.float().reshape(1, -1))
    h = h.to(cd).float()
    o = torch.cat([torch.matmul(h[:, :64], w2[:64, :32].to(cd).float()),
                   torch.matmul(h[:, 64:], w2[64:, 32:65].to(cd).float())], dim=1) \
        + b2.float().reshape(1, -1)[:, :65]
    col = torch.arange(65, device=feats.device)
    use = ((col < 32) & bool(rgb_sigmoid)) | \
        ((col >= 32) & (col < 64) & bool(sem_sigmoid))
    out = torch.where(use, torch.sigmoid(o) * (1 + 2 * 0.001) - 0.001, o).to(cd)
    return out[:, :64].contiguous(), out[:, 64:65].float()


class _LateSeparateDecode:
    """Callable wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            self._fn = cuda_build.load(
                NAME, "p2p3d_late_separate_decode",
                [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
        return self._fn

    def __call__(self, feats, w1, b1, w2, b2, rgb_sigmoid=True,
                 sem_sigmoid=False, compute_dtype=torch.bfloat16):
        """See the module docstring.  feats is cast to `compute_dtype`
        (float32 or bfloat16), and so are the weights."""
        cuda_build.refuse_autograd("late_separate_decode", feats, w1, b1, w2, b2)
        if feats.ndim != 2 or feats.shape[1] != 32:
            raise ValueError(f"feats must be [M, 32], got {tuple(feats.shape)}")
        if compute_dtype not in _DTYPES:
            raise TypeError(f"compute_dtype {compute_dtype} is not float32/bfloat16")
        if feats.dtype not in _DTYPES:
            raise TypeError(f"feats dtype {feats.dtype} is not float32/bfloat16")
        expect = {"w1": (w1, (32, 128)), "b1": (b1, (1, 128)),
                  "w2": (w2, (128, 128)), "b2": (b2, (1, 128))}
        for name, (a, shape) in expect.items():
            if tuple(a.shape) != shape:
                raise ValueError(f"{name} {tuple(a.shape)} != {shape}")
            if a.device != feats.device:
                raise ValueError(f"{name} on {a.device}, feats on {feats.device}")
            if a.dtype not in _DTYPES:
                raise TypeError(f"{name} dtype {a.dtype} is not float32/bfloat16")

        if feats.device.type == "cpu":
            return late_separate_decode_plain(
                feats, w1, b1, w2, b2, rgb_sigmoid=rgb_sigmoid,
                sem_sigmoid=sem_sigmoid, compute_dtype=compute_dtype)
        if feats.device.type != "cuda":
            raise ValueError(f"no kernel for device {feats.device}")
        if torch.cuda.get_device_capability(feats.device) != (9, 0):
            raise RuntimeError("the lateSeparate decode kernel is built for "
                               "sm_90a (Hopper); this device is "
                               f"{torch.cuda.get_device_name(feats.device)}")
        if not feats.is_contiguous():
            raise ValueError("feats must be contiguous")

        cd = compute_dtype
        x = feats.to(cd)
        if x.data_ptr() % 16:
            # the kernel reads rows in 16-byte (f32) or 4-byte (bf16) words;
            # a view that starts between them is copied to fresh memory
            x = x.clone()
        w1 = w1.to(cd).contiguous()
        w2 = w2.to(cd).contiguous()
        b1 = b1.float().contiguous()
        b2 = b2.float().contiguous()
        m = x.shape[0]
        colors = torch.empty((m, 64), dtype=cd, device=x.device)
        sigma = torch.empty((m, 1), dtype=torch.float32, device=x.device)
        fn = self._load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     b2.data_ptr(), colors.data_ptr(), sigma.data_ptr(), m,
                     int(cd == torch.bfloat16), int(bool(rgb_sigmoid)),
                     int(bool(sem_sigmoid)), stream)
        if err != 0:
            raise RuntimeError(f"late_separate_decode kernel launch failed: "
                               f"CUDA error {err}")
        self.launches += 1
        return colors, sigma


late_separate_decode = _LateSeparateDecode()
