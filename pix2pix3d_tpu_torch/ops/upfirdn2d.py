"""Pad / upsample / FIR-filter / downsample for batches of 2D images (NCHW).

Port of `pix2pix3d_tpu/ops/upfirdn2d.py`.  The behavioural spec is the
reference's pure implementation (`torch_utils/ops/upfirdn2d.py:_upfirdn2d_ref`):

    1. zero-insert upsample by `up` (each pixel followed by up-1 zeros),
    2. pad with `padding` (negative = crop),
    3. correlate with the (optionally flipped) FIR filter, valid windows only,
    4. keep every `down`-th pixel.

Filters are float32 `[fh, fw]` (non-separable) or `[taps]` (separable).

`upfirdn2d` is one op with a backward (`_Upfirdn2dFunction`): on CUDA
tensors one launch of the polyphase kernel `csrc/upfirdn2d.cu` (CUDA C++
for sm_90a, built by `ops/cuda_build.py` on first use and loaded with
`ctypes`), which writes the output in one pass and nothing else; on any
other device `upfirdn2d_plain`, the composition above (zero-insert, pad,
grouped depthwise convolution, slice).  There is no other fallback.  Each
launch adds one to `upfirdn2d.launches`.  The backward is the same op with
`up` and `down` swapped, the filter flipped and the adjoint padding, so
gradients and R1's double backward run the kernel too.  The filter takes no
gradient.  The JAX package has no kernel here (plain XLA).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import conv2d_gradfix, cuda_build

NAME = "upfirdn2d"   # csrc/upfirdn2d.cu
# the C entry's arguments: x, f, y; planes, in_h, in_w, out_h, out_w, upx,
# upy, downx, downy, px0, py0, fw, fh, separable, flip; gain; dtype; stream
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_double]
            + [ctypes.c_int] + [ctypes.c_void_p])
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _get_filter_size(f):
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None,
                 device="cpu"):
    """Prepare a FIR filter (ref `upfirdn2d.setup_filter`): accepts
    `[fh, fw]`, `[taps]`, scalar or None; normalizes to unit DC gain;
    separable representation for 1D filters with >= 8 taps."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.as_tensor(np.ascontiguousarray(f), dtype=torch.float32,
                           device=device)


def upfirdn2d_plain(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """The plain composition of `upfirdn2d` (arguments as there): what
    CPU tensors run, and what the kernel is checked against."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got {tuple(x.shape)}")
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    n, c, h, w = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)

    # 1. zero-insert upsample
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, h * upy, w * upx)
    # 2. pad / crop (F.pad crops on negative pads)
    x = F.pad(x, [px0, px1, py0, py1])
    # 3. correlate with the flipped filter
    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        x = conv2d_gradfix.conv2d(x, f[None, None].repeat(c, 1, 1, 1), groups=c)
    else:
        x = conv2d_gradfix.conv2d(x, f[None, None, None, :].repeat(c, 1, 1, 1),
                                  groups=c)
        x = conv2d_gradfix.conv2d(x, f[None, None, :, None].repeat(c, 1, 1, 1),
                                  groups=c)
    # 4. decimate
    if downx > 1 or downy > 1:
        x = x[:, :, ::downy, ::downx]
    return x


def _out_size(in_size, up, down, pad0, pad1, taps):
    return (in_size * up + pad0 + pad1 - taps) // down + 1


class _Upfirdn2dFunction(torch.autograd.Function):
    """`upfirdn2d` with parsed arguments (`up`, `down` as (x, y), `padding`
    as (x0, x1, y0, y1)); its backward is itself with the adjoint's
    arguments (ref `_upfirdn2d_cuda`)."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.save_for_backward(f)
        ctx.conf = (up, down, padding, flip_filter, gain, tuple(x.shape))
        if x.device.type == "cuda":
            return upfirdn2d.launch(x, f, up, down, padding, flip_filter, gain)
        return upfirdn2d_plain(x, f, up, down, list(padding), flip_filter, gain)

    @staticmethod
    def backward(ctx, dy):
        f, = ctx.saved_tensors
        (upx, upy), (downx, downy), (px0, _, py0, _), flip_filter, gain, shape = ctx.conf
        if ctx.needs_input_grad[1]:
            raise RuntimeError("upfirdn2d: the filter takes no gradient")
        dx = None
        if ctx.needs_input_grad[0]:
            ih, iw = shape[2:]
            oh, ow = dy.shape[2:]
            fw, fh = _get_filter_size(f)
            p = (fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
                 fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1)
            dx = _Upfirdn2dFunction.apply(dy, f, (downx, downy), (upx, upy), p,
                                          not flip_filter, gain)
        return dx, None, None, None, None, None, None


class _Upfirdn2d:
    """Callable op (the module's `upfirdn2d`); `launches` counts kernel
    launches."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            self._fn = cuda_build.load(NAME, "p2p3d_upfirdn2d", ARGTYPES)
        return self._fn

    def __call__(self, x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
        """Pad, upsample, FIR filter and downsample a batch of NCHW images.

        `padding` is int, `[x, y]` or `[x0, x1, y0, y1]`, relative to the
        upsampled image; negative values crop.  Differentiable in `x`."""
        if x.ndim != 4:
            raise ValueError(f"expected NCHW input, got {tuple(x.shape)}")
        if f is not None and f.ndim not in (1, 2):
            raise ValueError(f"the filter must be [taps] or [fh, fw], got {tuple(f.shape)}")
        return _Upfirdn2dFunction.apply(x, f, _parse_scaling(up), _parse_scaling(down),
                                        _parse_padding(padding), bool(flip_filter),
                                        float(gain))

    def args(self, x, f, y, up, down, padding, flip_filter, gain, stream):
        """The C entry's arguments for contiguous x, y and f (see ARGTYPES)."""
        n, c, h, w = x.shape
        fw, fh = _get_filter_size(f)
        return (x.data_ptr(), None if f is None else f.data_ptr(), y.data_ptr(),
                n * c, h, w, y.shape[2], y.shape[3], up[0], up[1], down[0], down[1],
                padding[0], padding[2], fw, fh, int(f is not None and f.ndim == 1),
                int(flip_filter), gain, _DTYPE_CODES[x.dtype], stream)

    def launch(self, x, f, up, down, padding, flip_filter, gain):
        """One kernel launch on the current stream; parsed arguments as
        `_Upfirdn2dFunction` takes them."""
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"upfirdn2d: no kernel for {x.dtype}")
        if torch.cuda.get_device_capability(x.device) != (9, 0):
            raise RuntimeError("the upfirdn2d kernel is built for sm_90a (Hopper); this "
                               f"device is {torch.cuda.get_device_name(x.device)}")
        if f is not None:
            if f.device != x.device:
                raise ValueError(f"filter on {f.device}, x on {x.device}")
            f = f.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
            f = f.contiguous()
        x = x.contiguous()
        fw, fh = _get_filter_size(f)
        n, c, h, w = x.shape
        out_h = _out_size(h, up[1], down[1], padding[2], padding[3], fh)
        out_w = _out_size(w, up[0], down[0], padding[0], padding[1], fw)
        if out_h <= 0 or out_w <= 0:
            raise ValueError(f"upfirdn2d: empty output for input {tuple(x.shape)}, "
                             f"up {up}, down {down}, padding {padding}, filter {fw}x{fh}")
        y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
        fn = self._load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*self.args(x, f, y, up, down, padding, flip_filter, gain, stream))
        if err != 0:
            raise RuntimeError(f"upfirdn2d kernel launch failed: CUDA error {err}")
        self.launches += 1
        return y


upfirdn2d = _Upfirdn2d()


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Filter NCHW images, output shape matches input."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample NCHW images with FIR smoothing."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)



def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample NCHW images with FIR anti-aliasing (ref `upfirdn2d.py:354-389`)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
