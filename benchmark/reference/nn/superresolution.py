"""Super-resolution modules, port of `pix2pix3d_tpu/nn/superresolution.py`
(ref `training/superresolution.py`), NCHW.

Each takes (rgb `[N, 3 or S, h, w]`, feature image `[N, 32, h, w]`, ws) and
returns the upsampled image; all reuse the last w broadcast over 3 layers.
Every class of the JAX package's registry is here: the 8XDC pair (the 512²
presets), 8X, the 4X pair and Deepfp32 (256²), and the 2X pair (128²).

A frozen copy for the benchmark's plain reference, without the grouped
dual-stack pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import bias_act
from ..ops.resize import resize_bilinear
from ..ops.upfirdn2d import upsample2d
from .layers import modulated_conv2d
from .synthesis import SynthesisBlock, _dtype, draw_noise


class SynthesisBlockNoUp(SynthesisBlock):
    """SynthesisBlock minus the upsampling (ref `superresolution.py:191-290`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, up=1, **kwargs)


class _SRBase(nn.Module):
    """Resize the inputs to `input_resolution` (when they differ from it,
    or with `resize_condition="lt"` only when they are smaller), run two
    blocks with the last w broadcast."""

    def __init__(self, block0, block1, input_resolution, sr_antialias,
                 resize_condition="ne"):
        super().__init__()
        self.block0 = block0
        self.block1 = block1
        self.input_resolution = input_resolution
        self.sr_antialias = sr_antialias
        self.resize_condition = resize_condition

    def resize(self, x):
        res = x.shape[2]
        need = (res < self.input_resolution if self.resize_condition == "lt"
                else res != self.input_resolution)
        if not need:
            return x
        return resize_bilinear(x, self.input_resolution, antialias=self.sr_antialias)

    def forward(self, rgb, x, ws, force_fp32=False, noise_mode="random",
                generator=None):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        x, rgb = self.resize(x), self.resize(rgb)
        x, rgb = self.block0(x, rgb, ws, force_fp32=force_fp32,
                             noise_mode=noise_mode, generator=generator)
        x, rgb = self.block1(x, rgb, ws, force_fp32=force_fp32,
                             noise_mode=noise_mode, generator=generator)
        return rgb


def _blk(cls, in_ch, out_ch, res, img_ch, use_fp16):
    return cls(in_ch, out_ch, w_dim=512, resolution=res, img_channels=img_ch,
               use_fp16=use_fp16, conv_clamp=256 if use_fp16 else None)


def _check(name, img_resolution, want):
    if img_resolution != want:
        raise ValueError(f"{name} outputs {want}^2, not {img_resolution}^2")


class SuperresolutionHybrid8XDC(_SRBase):
    """128 -> 512, wider channels (ref `superresolution.py:297-323`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 img_channels=3, **unused):
        _check("SuperresolutionHybrid8XDC", img_resolution, 512)
        fp16 = sr_num_fp16_res > 0
        super().__init__(
            _blk(SynthesisBlock, channels, 256, 256, img_channels, fp16),
            _blk(SynthesisBlock, 256, 128, 512, img_channels, fp16),
            input_resolution=128, sr_antialias=sr_antialias)


class SuperresolutionHybrid8XDCSemantic(SuperresolutionHybrid8XDC):
    """128 -> 512 semantic-channel variant (ref `superresolution.py:328-354`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 semantic_channels, **unused):
        super().__init__(channels, img_resolution, sr_num_fp16_res, sr_antialias,
                         img_channels=semantic_channels)


class SuperresolutionHybrid8X(_SRBase):
    """128 -> 512 (ref `superresolution.py:29-56`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 **unused):
        _check("SuperresolutionHybrid8X", img_resolution, 512)
        fp16 = sr_num_fp16_res > 0
        super().__init__(
            _blk(SynthesisBlock, channels, 128, 256, 3, fp16),
            _blk(SynthesisBlock, 128, 64, 512, 3, fp16),
            input_resolution=128, sr_antialias=sr_antialias)


class SuperresolutionHybrid4X(_SRBase):
    """128 -> 256 (ref `superresolution.py:62-88`): inputs resized only when
    smaller than 128²."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 img_channels=3, **unused):
        _check(type(self).__name__, img_resolution, 256)
        fp16 = sr_num_fp16_res > 0
        super().__init__(
            _blk(SynthesisBlockNoUp, channels, 128, 128, img_channels, fp16),
            _blk(SynthesisBlock, 128, 64, 256, img_channels, fp16),
            input_resolution=128, sr_antialias=sr_antialias, resize_condition="lt")


class SuperresolutionHybrid4XSemantic(SuperresolutionHybrid4X):
    """128 -> 256, semantic channels (the JAX package's completion of a
    class that the reference's `train.py:394` names but does not define)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 semantic_channels, **unused):
        super().__init__(channels, img_resolution, sr_num_fp16_res, sr_antialias,
                         img_channels=semantic_channels)


class SuperresolutionHybridDeepfp32(SuperresolutionHybrid4X):
    """Legacy 128 -> 256 (ref `superresolution.py:160-186`): the 4X stack
    without antialiasing, whatever `sr_antialias` says (the module predates
    the flag)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res,
                 sr_antialias=False, **unused):
        super().__init__(channels, img_resolution, sr_num_fp16_res, False)


class SuperresolutionHybrid2X(_SRBase):
    """64 -> 128 (ref `superresolution.py:94-121`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 img_channels=3, **unused):
        _check("SuperresolutionHybrid2X", img_resolution, 128)
        fp16 = sr_num_fp16_res > 0
        super().__init__(
            _blk(SynthesisBlockNoUp, channels, 128, 64, img_channels, fp16),
            _blk(SynthesisBlock, 128, 64, 128, img_channels, fp16),
            input_resolution=64, sr_antialias=sr_antialias)


class SuperresolutionHybrid2XSemantic(SuperresolutionHybrid2X):
    """64 -> 128, semantic channels (ref `superresolution.py:127-154`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 semantic_channels, **unused):
        super().__init__(channels, img_resolution, sr_num_fp16_res, sr_antialias,
                         img_channels=semantic_channels)



_SR_REGISTRY = {
    "SuperresolutionHybrid8X": SuperresolutionHybrid8X,
    "SuperresolutionHybrid4X": SuperresolutionHybrid4X,
    "SuperresolutionHybrid4X_semantic": SuperresolutionHybrid4XSemantic,
    "SuperresolutionHybrid2X": SuperresolutionHybrid2X,
    "SuperresolutionHybrid2X_semantic": SuperresolutionHybrid2XSemantic,
    "SuperresolutionHybridDeepfp32": SuperresolutionHybridDeepfp32,
    "SuperresolutionHybrid8XDC": SuperresolutionHybrid8XDC,
    "SuperresolutionHybrid8XDC_semantic": SuperresolutionHybrid8XDCSemantic,
}


def build_superresolution(name, **kwargs):
    """Construct an SR module by (reference-compatible) class name."""
    return _SR_REGISTRY[name.split(".")[-1]](**kwargs)
