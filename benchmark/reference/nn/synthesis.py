"""StyleGAN2 synthesis stack, port of `pix2pix3d_tpu/nn/synthesis.py`
(ref `networks_stylegan2.py:277-554`), NCHW.

Blocks flagged `use_fp16` run in bfloat16 tensors, as in the JAX package;
`force_fp32=True` runs everything in f32 for parity checks.  Noise is
'random' (the default, as in the JAX package: a fresh `[N, 1, res, res]`
normal draw from an explicit `torch.Generator`, times `noise_strength`),
'const' (the `noise_const` buffers) or 'none'.  Blocks take the
reference's three architectures: 'skip' (the one pix2pix3D builds: a ToRGB
in every block, the image upsampled and summed), 'orig' (ToRGB in the last
block only) and 'resnet' (a 1x1 up-convolution skip of x, gain sqrt(1/2)).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.upfirdn2d import setup_filter, upsample2d
from .layers import (Conv2d, FullyConnected, check_architecture, modulated_conv2d,
                     randn)
from .mapping import MappingNetwork


def draw_noise(shape, generator, device):
    """Standard normal draws from `generator` (on its own device), on
    `device`: the per-layer noise of noise_mode 'random'."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def _dtype(use_fp16, force_fp32):
    # the reference computes in f32 wherever the program may use bf16
    return torch.float32


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias/act (ref `networks_stylegan2.py:277-337`)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3,
                 up=1, use_noise=True, activation="lrelu",
                 resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        self.padding = kernel_size // 2
        self.act_gain = activation_funcs[activation].def_gain
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        if use_noise:
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
            self.noise_strength = nn.Parameter(torch.empty(()))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator))
            self.bias.zero_()
            if self.use_noise:
                self.noise_const.copy_(randn(self.noise_const.shape, generator))
                self.noise_strength.zero_()

    def forward(self, x, w, noise_mode="random", generator=None, gain=1.0):
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r} is not 'random', "
                             "'const' or 'none'")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            if generator is None:
                raise ValueError("noise_mode='random' needs a torch.Generator")
            res = self.noise_const.shape[0]
            noise = draw_noise((x.shape[0], 1, res, res), generator,
                               x.device) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, None]
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding,
                             resample_filter=self.resample_filter,
                             flip_weight=self.up == 1)
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, dim=1, act=self.activation,
                        gain=self.act_gain * gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv without demodulation (ref `networks_stylegan2.py:342-362`)."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1,
                 conv_clamp=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator))
            self.bias.zero_()

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, dim=1, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """Two synthesis layers and a ToRGB, in the 'orig', 'skip' or 'resnet'
    architecture (ref `networks_stylegan2.py:367-463`).  `up=1` gives the
    SR stacks' `SynthesisBlockNoUp` (no upsampling of x or img)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels,
                 is_last=True, architecture="skip", resample_filter=(1, 3, 3, 1),
                 conv_clamp=256, use_fp16=False, up=2, use_noise=True,
                 activation="lrelu"):
        super().__init__()
        check_architecture(architecture)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.resolution = resolution
        self.is_last = is_last
        self.architecture = architecture
        self.use_fp16 = use_fp16
        self.up = up
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        layer_kwargs = dict(w_dim=w_dim, resolution=resolution,
                            conv_clamp=conv_clamp, use_noise=use_noise,
                            activation=activation)
        self.num_conv = 0
        self.conv0 = None
        if in_channels != 0:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=up,
                                        resample_filter=resample_filter,
                                        **layer_kwargs)
            self.num_conv += 1
        self.conv1 = SynthesisLayer(out_channels, out_channels, **layer_kwargs)
        self.num_conv += 1
        self.torgb = None
        self.num_torgb = 0
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                    conv_clamp=conv_clamp)
            self.num_torgb = 1
        self.skip = None
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2d(in_channels, out_channels, kernel_size=1,
                               bias=False, up=up, resample_filter=resample_filter)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution,
                                                  resolution))

    def reset_parameters(self, generator):
        if self.in_channels == 0:
            with torch.no_grad():
                self.const.copy_(randn(self.const.shape, generator))

    def forward(self, x, img, ws, force_fp32=False, noise_mode="random",
                generator=None):
        if ws.shape[1] != self.num_conv + self.num_torgb:
            raise ValueError(f"block takes {self.num_conv + self.num_torgb} ws, "
                             f"got {ws.shape[1]}")
        dtype = _dtype(self.use_fp16, force_fp32)
        w_iter = iter(ws.unbind(dim=1))
        layer = dict(noise_mode=noise_mode, generator=generator)
        if self.in_channels == 0:
            x = self.const.to(dtype)[None].repeat(ws.shape[0], 1, 1, 1)
            x = self.conv1(x, next(w_iter), **layer)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x, next(w_iter), **layer)
            x = self.conv1(x, next(w_iter), gain=math.sqrt(0.5), **layer)
            x = y + x
        else:
            x = self.conv0(x.to(dtype), next(w_iter), **layer)
            x = self.conv1(x, next(w_iter), **layer)

        if img is not None and self.up > 1:
            img = upsample2d(img, self.resample_filter)
        if self.torgb is not None:
            y = self.torgb(x, next(w_iter)).float()
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """Stack of blocks 4x4 -> img_resolution (ref `networks_stylegan2.py:471-526`)."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_fp16_res=4, **block_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2 + 1)]
        channels_dict = {res: min(channel_base // res, channel_max)
                         for res in self.block_resolutions}
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        self.num_ws = 0
        for res in self.block_resolutions:
            is_last = res == img_resolution
            block = SynthesisBlock(
                channels_dict[res // 2] if res > 4 else 0, channels_dict[res],
                w_dim=w_dim, resolution=res, img_channels=img_channels,
                is_last=is_last, use_fp16=res >= fp16_resolution, **block_kwargs)
            # a block's ToRGB shares the next block's first w; the last one's
            # has its own
            self.num_ws += block.num_conv + (block.num_torgb if is_last else 0)
            self.add_module(f"b{res}", block)

    def forward(self, ws, force_fp32=False, noise_mode="random", generator=None):
        if ws.shape[1] != self.num_ws or ws.shape[2] != self.w_dim:
            raise ValueError(f"ws {tuple(ws.shape)} != [N, {self.num_ws}, "
                             f"{self.w_dim}]")
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            cur = ws[:, w_idx:w_idx + block.num_conv + block.num_torgb]
            w_idx += block.num_conv
            x, img = block(x, img, cur, force_fp32=force_fp32,
                           noise_mode=noise_mode, generator=generator)
        return img


class Generator(nn.Module):
    """Mapping + synthesis wrapper (ref `networks_stylegan2.py:531-554`)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels,
                                          **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        mk = dict(mapping_kwargs or {})
        mk.pop("class_name", None)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws, **mk)

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, **synthesis_kwargs)
