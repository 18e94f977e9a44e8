"""Super-resolution modules, port of `pix2pix3d_tpu/nn/superresolution.py`
(ref `training/superresolution.py`), NCHW.

Each takes (rgb `[N, 3 or S, h, w]`, feature image `[N, 32, h, w]`, ws) and
returns the upsampled image; all reuse the last w broadcast over 3 layers.
Ported: the 8XDC pair that the 512^2 presets build, and the 2X pair that
128^2 configurations (the CPU tests' small generator) build.
"""

from __future__ import annotations

from torch import nn

from ..ops.resize import resize_bilinear
from .synthesis import SynthesisBlock


class SynthesisBlockNoUp(SynthesisBlock):
    """SynthesisBlock minus the upsampling (ref `superresolution.py:191-290`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, up=1, **kwargs)


class _SRBase(nn.Module):
    """Resize the inputs to `input_resolution`, run two blocks with the
    last w broadcast."""

    def __init__(self, block0, block1, input_resolution, sr_antialias):
        super().__init__()
        self.block0 = block0
        self.block1 = block1
        self.input_resolution = input_resolution
        self.sr_antialias = sr_antialias

    def forward(self, rgb, x, ws, force_fp32=False, noise_mode="random",
                generator=None):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        x = resize_bilinear(x, self.input_resolution, antialias=self.sr_antialias)
        rgb = resize_bilinear(rgb, self.input_resolution, antialias=self.sr_antialias)
        x, rgb = self.block0(x, rgb, ws, force_fp32=force_fp32,
                             noise_mode=noise_mode, generator=generator)
        x, rgb = self.block1(x, rgb, ws, force_fp32=force_fp32,
                             noise_mode=noise_mode, generator=generator)
        return rgb


def _blk(cls, in_ch, out_ch, res, img_ch, use_fp16):
    return cls(in_ch, out_ch, w_dim=512, resolution=res, img_channels=img_ch,
               use_fp16=use_fp16, conv_clamp=256 if use_fp16 else None)


class SuperresolutionHybrid8XDC(_SRBase):
    """128 -> 512, wider channels (ref `superresolution.py:297-323`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 img_channels=3, **unused):
        if img_resolution != 512:
            raise ValueError("SuperresolutionHybrid8XDC is 128 -> 512")
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


class SuperresolutionHybrid2X(_SRBase):
    """64 -> 128 (ref `superresolution.py:94-121`)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 img_channels=3, **unused):
        if img_resolution != 128:
            raise ValueError("SuperresolutionHybrid2X is 64 -> 128")
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
    "SuperresolutionHybrid8XDC": SuperresolutionHybrid8XDC,
    "SuperresolutionHybrid8XDC_semantic": SuperresolutionHybrid8XDCSemantic,
    "SuperresolutionHybrid2X": SuperresolutionHybrid2X,
    "SuperresolutionHybrid2X_semantic": SuperresolutionHybrid2XSemantic,
}


def build_superresolution(name, **kwargs):
    """Construct an SR module by (reference-compatible) class name."""
    return _SR_REGISTRY[name.split(".")[-1]](**kwargs)
