"""Label-map encoder: conv pyramid -> W+ latents.

Port of `pix2pix3d_tpu/nn/encoder.py` (ref `training/triplane_cond.py:66-196`):
the plain, non-progressive resnet path with `output_mode='W+'` (the
disentangled mapping networks: `num_ws` latents) or `'W'` (the entangled
ones: one latent, repeated `num_ws` times).
"""

from __future__ import annotations

import math

from torch import nn

from .discriminator import DiscriminatorBlock
from .layers import EqualConv2d


class Encoder(nn.Module):
    def __init__(self, img_resolution, img_channels, bottleneck_factor=2,
                 channel_base=1, channel_max=512, num_fp16_res=0, conv_clamp=None,
                 model_kwargs=None):
        super().__init__()
        model_kwargs = model_kwargs or {}
        self.output_mode = model_kwargs.get("output_mode", "W+")
        if self.output_mode not in ("W", "W+"):
            raise ValueError("only output_mode 'W' and 'W+' are ported")
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, bottleneck_factor, -1)]
        channel_base = int(channel_base * 32768)
        channels_dict = {res: min(channel_base // res, channel_max)
                         for res in self.block_resolutions + [4]}
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels_dict[res] if res < img_resolution else 0,
                channels_dict[res], channels_dict[res // 2],
                img_channels=img_channels, conv_clamp=conv_clamp,
                use_fp16=res >= fp16_resolution))
        self.num_ws = model_kwargs.get("num_ws", 0)
        self.w_dim = model_kwargs.get("w_dim", 512)
        n_latents = self.num_ws if self.output_mode == "W+" else 1
        self.projector = EqualConv2d(channels_dict[4], self.w_dim * n_latents, 4,
                                     padding=0, bias=False)

    def forward(self, img, force_fp32=False):
        """img `[N, C, H, W]` one-hot map -> {'ws': [N, num_ws, w_dim]}."""
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        out = self.projector(x)[:, :, 0, 0]
        if self.output_mode == "W":
            return {"ws": out[:, None, :].repeat(1, self.num_ws, 1)}
        return {"ws": out.reshape(out.shape[0], self.num_ws, self.w_dim)}
