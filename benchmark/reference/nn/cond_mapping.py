"""Conditional mapping networks: label or edge map (+z, +c) -> ws.

Port of `pix2pix3d_tpu/nn/cond_mapping.py` (ref `training/triplane_cond.py
:202-592`; the JAX `_CondMappingBase` is folded in).  The `Disentangle`
variants are the ones every shipped config uses: the map's encoder produces
the first `geometry_layer` W+ latents (geometry); z and the camera c drive
the remaining broadcast style latents (appearance).  The entangled
`MaskMappingNetwork` / `EdgeMappingNetwork` instead concatenate the
encoder's single W with z (and the embedded c) before the FC stack and
broadcast the result to every latent.  Seg configs feed the encoder a
one-hot label map, edge configs the raw 1-channel edge map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import Encoder
from .layers import FullyConnected, normalize_2nd_moment


def _one_hot_mask(mask, num_channels):
    """mask `[N, H, W, 1]` integer labels -> `[N, C, H, W]` one-hot float."""
    return F.one_hot(mask[..., 0].long(), num_channels).permute(0, 3, 1, 2).float()


def _encoder_input(batch, in_channels, one_hot):
    mask = batch["mask"]
    return (_one_hot_mask(mask, in_channels) if one_hot
            else mask.permute(0, 3, 1, 2).float())


class MaskMappingNetwork(nn.Module):
    """Entangled variant (ref `triplane_cond.py:202-296`): the encoder's W,
    normalized, joins z before the FC stack; `w_avg` is one `[w_dim]`
    vector."""

    def __init__(self, z_dim, c_dim, in_resolution, in_channels, w_dim, num_ws,
                 num_layers=8, embed_features=None, layer_features=None,
                 activation="lrelu", lr_multiplier=0.01, w_avg_beta=0.995,
                 encoder_channel_base=1, encoder_channel_max=512,
                 encoder_num_fp16_res=0, one_hot=True, **unused):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.in_channels = in_channels
        self.one_hot = one_hot
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        ef = w_dim if embed_features is None else embed_features
        layer_features = w_dim if layer_features is None else layer_features
        features = ([z_dim + ef * (2 if c_dim else 1)]
                    + [layer_features] * (num_layers - 1) + [w_dim])
        self.embed_mask = Encoder(
            img_resolution=in_resolution, img_channels=in_channels,
            channel_base=encoder_channel_base, channel_max=encoder_channel_max,
            num_fp16_res=encoder_num_fp16_res,
            conv_clamp=256 if encoder_num_fp16_res else None,
            model_kwargs={"num_ws": 1, "w_dim": ef, "output_mode": "W"})
        self.embed = FullyConnected(c_dim, ef) if c_dim > 0 else None
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnected(
                features[i], features[i + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z=None, c=None, batch=None, truncation_psi=1.0, **unused):
        mask = _encoder_input(batch, self.in_channels, self.one_hot)
        x = normalize_2nd_moment(self.embed_mask(mask)["ws"][:, 0].float())
        if self.z_dim > 0:
            x = torch.cat([normalize_2nd_moment(z.float()), x], dim=1)
        if self.c_dim > 0:
            x = torch.cat([x, normalize_2nd_moment(self.embed(c.float()))], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            x = self.w_avg + truncation_psi * (x - self.w_avg)
        return x


class EdgeMappingNetwork(MaskMappingNetwork):
    """Edge-map variant of the entangled mapping (ref `triplane_cond.py
    :404-493`): the raw 1-channel edge map, no one-hot."""

    def __init__(self, *args, **kwargs):
        kwargs["one_hot"] = False
        super().__init__(*args, **kwargs)


class MaskMappingNetworkDisentangle(nn.Module):
    def __init__(self, z_dim, c_dim, in_resolution, in_channels, w_dim, num_ws,
                 num_layers=8, embed_features=None, layer_features=None,
                 activation="lrelu", lr_multiplier=0.01, w_avg_beta=0.995,
                 encoder_channel_base=1, encoder_channel_max=512,
                 encoder_num_fp16_res=0, geometry_layer=7, one_hot=True, **unused):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.in_resolution = in_resolution
        self.in_channels = in_channels
        self.one_hot = one_hot
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.geometry_layer = geometry_layer
        self.w_avg_beta = w_avg_beta
        embed_features = w_dim if embed_features is None else embed_features
        layer_features = w_dim if layer_features is None else layer_features
        features = ([z_dim + (embed_features if c_dim else 0)]
                    + [layer_features] * (num_layers - 1) + [w_dim])
        # serving runs the trailing `encoder_num_fp16_res` encoder
        # resolutions in bf16 tensors
        self.embed_mask = Encoder(
            img_resolution=in_resolution, img_channels=in_channels,
            channel_base=encoder_channel_base, channel_max=encoder_channel_max,
            num_fp16_res=encoder_num_fp16_res,
            conv_clamp=256 if encoder_num_fp16_res else None,
            model_kwargs={"num_ws": geometry_layer, "w_dim": w_dim})
        self.embed = FullyConnected(c_dim, embed_features) if c_dim > 0 else None
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnected(
                features[i], features[i + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.zeros(num_ws, w_dim))

    def forward(self, z=None, c=None, batch=None, truncation_psi=1.0, **unused):
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            ce = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, ce], dim=1) if x is not None else ce
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)

        mask = _encoder_input(batch, self.in_channels, self.one_hot)
        y = self.embed_mask(mask)["ws"].float()                  # [N, G, w_dim]
        x = x[:, None, :].repeat(1, self.num_ws - self.geometry_layer, 1)
        x = torch.cat([y, x], dim=1)
        if truncation_psi != 1:
            x = self.w_avg + truncation_psi * (x - self.w_avg)
        return x


class EdgeMappingNetworkDisentangle(MaskMappingNetworkDisentangle):
    """Edge-map variant (ref `triplane_cond.py:499-592`): the raw 1-channel
    edge map, no one-hot."""

    def __init__(self, *args, **kwargs):
        kwargs["one_hot"] = False
        super().__init__(*args, **kwargs)
