"""Equalized-lr layers and style-modulated convolution (NCHW).

Port of `pix2pix3d_tpu/nn/layers.py`.  Parameter names mirror the JAX
package's param tree (`weight`, `bias`, `affine`, ...), so `bridge.py` maps
a JAX tree onto `state_dict()` keys one to one.  Every module that owns
parameters has `reset_parameters(generator)`, which draws them as the JAX
package's `init` does (from a `torch.Generator` instead of a PRNG key).

`modulated_conv2d` uses the JAX package's input-scaling formulation: the
styles scale the input channels before ONE shared-weight convolution and the
demodulation coefficients scale the output channels after it -- equal to the
reference's per-sample weights for f32, without materializing them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.upfirdn2d import setup_filter


def check_architecture(architecture):
    """The reference's block architectures: 'orig', 'skip', 'resnet'."""
    if architecture not in ("orig", "skip", "resnet"):
        raise ValueError(f"architecture {architecture!r} is not 'orig', "
                         "'skip' or 'resnet'")


def normalize_2nd_moment(x, dim=1, eps=1e-8):
    """PixelNorm (ref `networks_stylegan2.py:27-29`)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def randn(shape, generator):
    """Standard normal f32 tensor on the CPU from `generator`."""
    return torch.randn(shape, generator=generator, dtype=torch.float32)


class FullyConnected(nn.Module):
    """Equalized-lr linear layer; weight `[out, in]` (the JAX tree holds
    `[in, out]`), init N(0,1)/lr_multiplier, runtime gain
    lr_multiplier/sqrt(in)."""

    def __init__(self, in_features, out_features, bias=True, activation="linear",
                 lr_multiplier=1.0, bias_init=0.0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activation = activation
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.bias_gain = lr_multiplier
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator)
                              / self.lr_multiplier)
            if self.bias is not None:
                self.bias.fill_(float(self.bias_init))

    def forward(self, x):
        w = self.weight.to(x.dtype) * self.weight_gain
        b = self.bias
        if b is not None:
            b = b.to(x.dtype)
            if self.bias_gain != 1:
                b = b * self.bias_gain
        return bias_act(F.linear(x, w), b, dim=1, act=self.activation)


class Conv2d(nn.Module):
    """Equalized-lr conv with optional FIR up/downsampling (ref
    `Conv2dLayer`)."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True,
                 activation="linear", up=1, down=1, resample_filter=(1, 3, 3, 1),
                 conv_clamp=None):
        super().__init__()
        self.activation = activation
        self.up = up
        self.down = down
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        self.padding = kernel_size // 2
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.act_gain = activation_funcs[activation].def_gain
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, gain=1.0):
        w = self.weight * self.weight_gain
        x = conv2d_resample(x, w.to(x.dtype), f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding,
                            flip_weight=self.up == 1)
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, dim=1, act=self.activation,
                        gain=self.act_gain * gain, clamp=act_clamp)


class EqualConv2d(nn.Module):
    """Plain equalized conv (ref `triplane_cond.py:30-61`; encoder projector)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.scale = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = (self.weight * self.scale).to(x.dtype)
        out = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)[None, :, None, None]
        return out


def modulated_conv2d(x, weight, styles, noise=None, up=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True,
                     groups=1):
    """Style-modulated conv (ref `networks_stylegan2.py:34-91`), NCHW.

    x `[B, I, H, W]`, weight `[O, I // groups, kh, kw]`, styles `[B, I]`,
    noise broadcastable to `[B, 1, H', W']`.  With `groups` > 1 the
    channels split into independent convolutions (the dual SR pass runs two
    stacks' layers as one grouped convolution), each demodulated over its
    own inputs."""
    dcoefs = None
    if demodulate:
        b, o = styles.shape[0], weight.shape[0]
        w_sq = weight.float().square().sum(dim=(2, 3))            # [O, I/G]
        s_sq = styles.float().square()                            # [B, I]
        if groups == 1:
            dcoefs = torch.rsqrt(s_sq @ w_sq.t() + 1e-8)          # [B, O]
        else:
            d = torch.einsum("bgi,goi->bgo", s_sq.reshape(b, groups, -1),
                             w_sq.reshape(groups, o // groups, -1))
            dcoefs = torch.rsqrt(d.reshape(b, o) + 1e-8)

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        padding=padding, groups=groups, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


def minibatch_stddev(x, group_size=4, num_channels=1):
    """Minibatch stddev feature (ref `MinibatchStdLayer`,
    `networks_stylegan2.py:648-672`), NCHW: x `[N, C, H, W]` ->
    `[N, C + num_channels, H, W]`."""
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    cc = c // f
    y = x.float().reshape(g, -1, f, cc, h, w)         # [G, n, F, c, H, W]
    y = y - y.mean(dim=0, keepdim=True)
    y = y.square().mean(dim=0)                        # [n, F, c, H, W]
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(2, 3, 4))                         # [n, F]
    y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)
