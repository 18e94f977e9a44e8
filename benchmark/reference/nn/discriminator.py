"""Discriminators, port of `pix2pix3d_tpu/nn/discriminator.py` (ref
`networks_stylegan2.py:559-796`, `training/dual_discriminator.py`), NCHW.

Blocks and the epilogue take the reference's three architectures: 'resnet'
(the one every shipped config builds: the mask encoder of the conditional
mapping network is made of `DiscriminatorBlock`s, and training runs two
`DualDiscriminator`s, D over [image | raw] and D_semantic over [image |
semantic]), 'skip' (a FromRGB in every block and the epilogue, the image
downsampled alongside) and 'orig' (a FromRGB in the first block only), which
legacy TensorFlow pickles select (`utils/legacy_tf.py`).  Blocks at the
`num_fp16_res` highest resolutions run in bfloat16 tensors, as in the JAX
package; the epilogue runs in f32.

Inputs are NCHW image dicts `{"image": [N, C, H, W], "image_raw": [N, C, h,
w]}`.  The epilogue's `fc` flattens its `[N, C, 4, 4]` input in the JAX
package's NHWC order, so its weight is the JAX tree's (transposed) as is and
`bridge.params_from_jax` loads a JAX-initialized discriminator one to one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from .layers import Conv2d, FullyConnected, check_architecture, minibatch_stddev
from .mapping import MappingNetwork


def draw_normal(generator, shape, device):
    """Standard normal draws from `generator` (on its own device), on
    `device`: the conditioning noise of `disc_c_noise`."""
    if generator is None:
        raise ValueError("disc_c_noise > 0 draws random numbers: pass a "
                         "torch.Generator")
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


class DiscriminatorBlock(nn.Module):
    """Downsampling block (ref `networks_stylegan2.py:559-643`).  Training
    updates every layer, in the port as in the JAX package, so
    `freeze_layers` (a legacy pickle's kwarg) is refused unless it is 0."""

    def __init__(self, in_channels, tmp_channels, out_channels, img_channels,
                 activation="lrelu", resample_filter=(1, 3, 3, 1), conv_clamp=None,
                 use_fp16=False, architecture="resnet", freeze_layers=0):
        super().__init__()
        if in_channels not in (0, tmp_channels):
            raise ValueError("in_channels must be 0 or tmp_channels")
        check_architecture(architecture)
        if freeze_layers:
            raise ValueError(f"freeze_layers={freeze_layers}: training updates "
                             "every layer, so only 0 is accepted")
        self.in_channels = in_channels
        self.architecture = architecture
        self.use_fp16 = use_fp16
        self.register_buffer("resample_filter",
                             setup_filter(list(resample_filter)),
                             persistent=False)
        self.fromrgb = None
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2d(img_channels, tmp_channels, kernel_size=1,
                                  activation=activation, conv_clamp=conv_clamp)
        self.conv0 = Conv2d(tmp_channels, tmp_channels, kernel_size=3,
                            activation=activation, conv_clamp=conv_clamp)
        self.conv1 = Conv2d(tmp_channels, out_channels, kernel_size=3,
                            activation=activation, down=2,
                            resample_filter=resample_filter, conv_clamp=conv_clamp)
        self.skip = None
        if architecture == "resnet":
            self.skip = Conv2d(tmp_channels, out_channels, kernel_size=1, bias=False,
                               down=2, resample_filter=resample_filter)

    def forward(self, x, img, force_fp32=False):
        """x `[N, C, H, W]` or None (first block), img the input image (with
        'skip', this resolution's); returns (x at half resolution, the image
        downsampled with 'skip', else img, None after a FromRGB)."""
        dtype = torch.float32  # the reference computes in f32
        if x is not None:
            x = x.to(dtype)
        if self.fromrgb is not None:
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter)
                   if self.architecture == "skip" else None)
        if self.skip is not None:
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            return y + x, img
        x = self.conv0(x)
        return self.conv1(x), img


class DiscriminatorEpilogue(nn.Module):
    """4x4 epilogue with minibatch-std and the conditioning projection
    (ref `networks_stylegan2.py:677-733`), always f32."""

    def __init__(self, in_channels, cmap_dim, resolution, img_channels,
                 architecture="resnet", mbstd_group_size=4, mbstd_num_channels=1,
                 activation="lrelu", conv_clamp=None, **unused_kwargs):
        super().__init__()
        check_architecture(architecture)
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.fromrgb = None
        if architecture == "skip":
            self.fromrgb = Conv2d(img_channels, in_channels, kernel_size=1,
                                  activation=activation)
        self.conv = Conv2d(in_channels + mbstd_num_channels, in_channels,
                           kernel_size=3, activation=activation, conv_clamp=conv_clamp)
        self.fc = FullyConnected(in_channels * resolution ** 2, in_channels,
                                 activation=activation)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, img, cmap, force_fp32=False):
        x = x.float()
        if self.fromrgb is not None:
            x = x + self.fromrgb(img.float())
        if self.mbstd_num_channels > 0:
            x = minibatch_stddev(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        x = self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))  # NHWC order
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(self.cmap_dim))
        return x


class _DiscriminatorBase(nn.Module):
    """Shared trunk construction for the discriminator variants."""

    def __init__(self, c_dim, img_resolution, img_channels, architecture="resnet",
                 channel_base=32768, channel_max=512, num_fp16_res=4, conv_clamp=256,
                 cmap_dim=None, block_kwargs=None, mapping_kwargs=None,
                 epilogue_kwargs=None, **unused_kwargs):
        super().__init__()
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        channels_dict = {res: min(channel_base // res, channel_max)
                         for res in self.block_resolutions + [4]}
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        if cmap_dim is None:
            cmap_dim = channels_dict[4]
        if c_dim == 0:
            cmap_dim = 0
        self.cmap_dim = cmap_dim

        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels_dict[res] if res < img_resolution else 0,
                channels_dict[res], channels_dict[res // 2],
                img_channels=img_channels, conv_clamp=conv_clamp,
                use_fp16=res >= fp16_resolution, architecture=architecture,
                **(block_kwargs or {})))
        self.mapping = None
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim,
                                          num_ws=None, w_avg_beta=None,
                                          **(mapping_kwargs or {}))
        self.b4 = DiscriminatorEpilogue(channels_dict[4], cmap_dim=cmap_dim,
                                        resolution=4, img_channels=img_channels,
                                        architecture=architecture,
                                        conv_clamp=conv_clamp,
                                        **(epilogue_kwargs or {}))

    def _trunk(self, img, c, force_fp32=False):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap, force_fp32=force_fp32)


class Discriminator(_DiscriminatorBase):
    """Plain StyleGAN2 discriminator over an NCHW image tensor
    (ref `networks_stylegan2.py:738-796`)."""

    def forward(self, img, c, force_fp32=False, **unused_kwargs):
        return self._trunk(img, c, force_fp32=force_fp32)


class SingleDiscriminator(_DiscriminatorBase):
    """Discriminator over `img['image']` only (ref `dual_discriminator.py:21-82`)."""

    def forward(self, img, c, force_fp32=False, **unused_kwargs):
        return self._trunk(img["image"], c, force_fp32=force_fp32)


def filtered_resizing(image, size, f, filter_mode="antialiased"):
    """Resize NCHW `image` to `size` (ref `dual_discriminator.py:86-102`)."""
    if filter_mode == "antialiased":
        return resize_bilinear(image, size, antialias=True)
    if filter_mode == "classic":
        x = upsample2d(image, f, up=2)
        x = resize_bilinear(x, size * 2 + 2, antialias=False)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if filter_mode == "none":
        return resize_bilinear(image, size, antialias=False)
    if isinstance(filter_mode, float):
        if not 0 < filter_mode < 1:
            raise ValueError(filter_mode)
        filtered = resize_bilinear(image, size, antialias=True)
        aliased = resize_bilinear(image, size, antialias=False)
        return (1 - filter_mode) * aliased + filter_mode * filtered
    raise ValueError(filter_mode)


class DualDiscriminator(_DiscriminatorBase):
    """Dual discrimination over the channel concat [image, upsampled raw
    render] (ref `dual_discriminator.py:107-175`).  D_semantic is this class
    built with img_channels = rgb + semantic channels.

    `raw_fade` (a float or a 0-d tensor, default 1) scales the raw branch;
    `disc_c_noise > 0` adds `N(0, 1) * std(c) * disc_c_noise` to the
    conditioning, drawn from `generator` through `draw_normal`."""

    def __init__(self, c_dim, img_resolution, img_channels, disc_c_noise=0,
                 **kwargs):
        super().__init__(c_dim, img_resolution, img_channels * 2, **kwargs)
        self.disc_c_noise = disc_c_noise
        self.register_buffer("resample_filter", setup_filter([1, 3, 3, 1]),
                             persistent=False)

    def forward(self, img, c, force_fp32=False, generator=None, raw_fade=None,
                **unused_kwargs):
        image_raw = filtered_resizing(img["image_raw"], size=img["image"].shape[-1],
                                      f=self.resample_filter)
        if raw_fade is not None:
            image_raw = image_raw * raw_fade
        x = torch.cat([img["image"], image_raw], dim=1)
        trunk_x = None
        for res in self.block_resolutions:
            trunk_x, x = getattr(self, f"b{res}")(trunk_x, x, force_fp32=force_fp32)
        cmap = None
        if self.c_dim > 0:
            if self.disc_c_noise > 0:
                noise = draw_normal(generator, c.shape, c.device)
                c = c + noise * c.std(dim=0, unbiased=False) * self.disc_c_noise
            cmap = self.mapping(None, c)
        return self.b4(trunk_x, x, cmap, force_fp32=force_fp32)
