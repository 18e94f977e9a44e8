"""Latent mapping network z (+c) -> w, port of `pix2pix3d_tpu/nn/mapping.py`
(ref `MappingNetwork`, `networks_stylegan2.py:193-272`)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import FullyConnected, normalize_2nd_moment


class MappingNetwork(nn.Module):
    """z + optional label c -> broadcast w's; `w_avg` is a buffer."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8,
                 embed_features=None, layer_features=None, activation="lrelu",
                 lr_multiplier=0.01, w_avg_beta=0.998, **unused_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta

        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        if layer_features is None:
            layer_features = w_dim
        features = ([z_dim + embed_features] + [layer_features] * (num_layers - 1)
                    + [w_dim])
        self.embed = FullyConnected(c_dim, embed_features) if c_dim > 0 else None
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnected(
                features[i], features[i + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z, c=None, truncation_psi=1.0, truncation_cutoff=None):
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x
