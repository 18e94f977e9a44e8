"""Super-resolution modules, port of `pix2pix3d_tpu/nn/superresolution.py`
(ref `training/superresolution.py`), NCHW.

Each takes (rgb `[N, 3 or S, h, w]`, feature image `[N, 32, h, w]`, ws) and
returns the upsampled image; all reuse the last w broadcast over 3 layers.
Every class of the JAX package's registry is here: the 8XDC pair (the 512²
presets), 8X, the 4X pair and Deepfp32 (256²), and the 2X pair (128²).

`dual_superresolution` runs an rgb stack and a semantic stack of the same
topology as one pass: each layer of the two stacks becomes one grouped
convolution (groups=2) over their concatenated channels, with ToRGB
zero-padded to the wider of the two image widths, as the JAX package pads
it before its `vmap`.
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


# ------------------------------------------------------------------ dual SR

def dual_sr_compatible(sr_rgb, sr_sem):
    """True when the two stacks can run as one grouped pass: the same block
    types, widths, resolutions and precisions, the same resize; only the
    ToRGB width may differ (3 against the semantic channels)."""
    def sig(m):
        return ([(type(b).__name__, b.in_channels, b.out_channels, b.resolution,
                  b.up, b.use_fp16) for b in (m.block0, m.block1)]
                + [m.input_resolution, m.resize_condition, m.sr_antialias])
    return sig(sr_rgb) == sig(sr_sem)


def _pad_img(img, width):
    return F.pad(img, (0, 0, 0, 0, 0, width - img.shape[1]))


def _pad_out(t, width):
    """Zero rows after the first dim of a weight `[O, ...]` or bias `[O]`."""
    return F.pad(t, [0, 0] * (t.ndim - 1) + [0, width - t.shape[0]])


def _dual_layer(la, lb, x, w, noise_mode, noises):
    """SynthesisLayers `la`, `lb` on their concatenated inputs `x` `[N, 2I,
    H, W]` as one grouped modulated convolution; noise added per stack."""
    styles = torch.cat([la.affine(w), lb.affine(w)], dim=1)
    x = modulated_conv2d(x, torch.cat([la.weight, lb.weight]), styles,
                         up=la.up, padding=la.padding,
                         resample_filter=la.resample_filter,
                         flip_weight=la.up == 1, groups=2)
    if la.use_noise and noise_mode != "none":
        if noise_mode == "random":
            na, nb = (n * layer.noise_strength for n, layer in zip(noises, (la, lb)))
        else:
            na, nb = ((layer.noise_const * layer.noise_strength)[None, None]
                      for layer in (la, lb))
        n, c, h, wd = x.shape
        noise = torch.stack([na.expand(n, 1, h, wd), nb.expand(n, 1, h, wd)], dim=1)
        x = (x.reshape(n, 2, c // 2, h, wd) + noise.to(x.dtype)).reshape(n, c, h, wd)
    return bias_act(x, torch.cat([la.bias, lb.bias]), dim=1, act=la.activation,
                    gain=la.act_gain, clamp=la.conv_clamp)


def _dual_torgb(ta, tb, x, w, width):
    styles = torch.cat([ta.affine(w) * ta.weight_gain,
                        tb.affine(w) * tb.weight_gain], dim=1)
    weight = torch.cat([_pad_out(ta.weight, width), _pad_out(tb.weight, width)])
    x = modulated_conv2d(x, weight, styles, demodulate=False, groups=2)
    bias = torch.cat([_pad_out(ta.bias, width), _pad_out(tb.bias, width)])
    return bias_act(x, bias, dim=1, clamp=ta.conv_clamp)


def _noise_layers(sr):
    return [layer for b in (sr.block0, sr.block1) for layer in (b.conv0, b.conv1)]


def dual_superresolution(sr_rgb, sr_sem, rgb, x_rgb, sem, x_sem, ws,
                         noise_mode="random", generator=None, force_fp32=False):
    """`sr_rgb(rgb, x_rgb, ws)` and `sr_sem(sem, x_sem, ws)` as one pass
    (both stacks `dual_sr_compatible`): (rgb image `[N, 3, H, W]`, semantic
    image `[N, S, H, W]`), equal to the two separate calls up to summation
    order.  The padding is exact: ToRGB is a non-demodulated 1x1 modulated
    convolution plus bias, so zero weight rows and zero bias give zero
    channels, which stay zero through the skip images' upsampling.  With
    noise_mode "random" the noise is drawn from `generator` in the separate
    calls' order (every layer of the rgb stack, then the semantic one's), so
    both ways draw the same numbers."""
    if not dual_sr_compatible(sr_rgb, sr_sem):
        raise ValueError("the two SR stacks differ in topology")
    width = max(rgb.shape[1], sem.shape[1])
    n_sem = sem.shape[1]
    ws = ws[:, -1:, :].repeat(1, 3, 1)
    x = torch.cat([sr_rgb.resize(x_rgb), sr_sem.resize(x_sem)], dim=1)
    img = torch.cat([_pad_img(sr_rgb.resize(rgb), width),
                     _pad_img(sr_sem.resize(sem), width)], dim=1)
    pairs = list(zip(_noise_layers(sr_rgb), _noise_layers(sr_sem)))
    noises = [(None, None)] * len(pairs)
    if noise_mode == "random":
        if generator is None:
            raise ValueError("noise_mode='random' needs a torch.Generator")
        n = x.shape[0]
        drawn = [draw_noise((n, 1, layer.noise_const.shape[0],
                             layer.noise_const.shape[0]), generator, x.device)
                 for stack in (0, 1) for layer in (p[stack] for p in pairs)]
        noises = list(zip(drawn[:len(pairs)], drawn[len(pairs):]))
    k = 0
    for ba, bb in ((sr_rgb.block0, sr_sem.block0), (sr_rgb.block1, sr_sem.block1)):
        dtype = _dtype(ba.use_fp16, force_fp32)
        w0, w1, w2 = ws.unbind(dim=1)
        x = _dual_layer(ba.conv0, bb.conv0, x.to(dtype), w0, noise_mode, noises[k])
        x = _dual_layer(ba.conv1, bb.conv1, x, w1, noise_mode, noises[k + 1])
        k += 2
        if ba.up > 1:
            img = upsample2d(img, ba.resample_filter)
        img = img + _dual_torgb(ba.torgb, bb.torgb, x, w2, width).float()
    return img[:, :3], img[:, width:width + n_sem]


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
