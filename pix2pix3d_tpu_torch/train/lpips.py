"""LPIPS perceptual distance (VGG16 backbone), port of
`pix2pix3d_tpu/train/lpips.py`, NCHW.

    d(x, y) = sum_l  mean_hw( || w_l * (phi_l(x)^ - phi_l(y)^) ||^2 )

phi_l are the conv-block activations (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3), ^ is unit normalization over channels, w_l the 1x1 "lin" weights.

Weights: an `.npz` in the layout of the JAX module's `LPIPS(weights_path=...)`
(`conv{i}_w` HWIO `[3, 3, in, out]`, `conv{i}_b`, `lin{l}_w`; made by
`scripts/convert_lpips.py`).  The tree ships none, so without one the module
draws a fixed-seed *random* VGG (He-normal convs, uniform lin weights) and
warns, as the JAX module does: a perceptual-ish training signal, not the
published LPIPS metric.  The port draws its random VGG from
`torch.Generator().manual_seed(80085)`, so its numbers differ from the JAX
module's `PRNGKey(80085)` draws; `load_params` takes the JAX module's tree.

The parameters never train: they are buffers.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 feature config: (out_channels, n_convs) per block.
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# the lpips package's scaling layer for inputs in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
RANDOM_SEED = 80085


class LPIPS(nn.Module):
    def __init__(self, weights_path=None):
        super().__init__()
        idx, in_ch = 0, 3
        for out_ch, n_convs in _VGG_BLOCKS:
            for _ in range(n_convs):
                self.register_buffer(f"conv{idx}_w", torch.zeros(out_ch, in_ch, 3, 3))
                self.register_buffer(f"conv{idx}_b", torch.zeros(out_ch))
                in_ch = out_ch
                idx += 1
        for i, (out_ch, _) in enumerate(_VGG_BLOCKS):
            self.register_buffer(f"lin{i}_w", torch.zeros(out_ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)
        self.has_pretrained = False
        if weights_path and os.path.exists(weights_path):
            with np.load(weights_path) as data:
                self.load_params({k: data[k] for k in data.files})
            self.has_pretrained = True
        else:
            if weights_path:
                warnings.warn(f"LPIPS weights not found at {weights_path}; "
                              "falling back to random-feature VGG.")
            else:
                warnings.warn(
                    "LPIPS running with RANDOM VGG features (no pretrained "
                    "weights available in this environment). This is a valid "
                    "perceptual-ish loss but not the published LPIPS metric.")
            self._random_init(torch.Generator().manual_seed(RANDOM_SEED))

    @torch.no_grad()
    def _random_init(self, generator):
        idx, in_ch = 0, 3
        for out_ch, n_convs in _VGG_BLOCKS:
            for _ in range(n_convs):
                std = float(np.sqrt(2.0 / (3 * 3 * in_ch)))
                w = torch.randn((out_ch, in_ch, 3, 3), generator=generator) * std
                getattr(self, f"conv{idx}_w").copy_(w)
                getattr(self, f"conv{idx}_b").zero_()
                in_ch = out_ch
                idx += 1
        for i, (out_ch, _) in enumerate(_VGG_BLOCKS):
            getattr(self, f"lin{i}_w").fill_(1.0 / out_ch)

    @torch.no_grad()
    def load_params(self, params):
        """Weights in the JAX module's layout (numpy arrays; conv HWIO)."""
        for name, buf in self.state_dict().items():
            a = np.asarray(params[name], np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            getattr(self, name).copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def features(self, x):
        """x `[N, 3, H, W]` in [-1, 1] -> the 5 block activations."""
        x = (x - self.shift) / self.scale
        feats = []
        idx = 0
        for block_i, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{idx}_w"),
                                    getattr(self, f"conv{idx}_b"), padding=1))
                idx += 1
            feats.append(x)
            if block_i < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, x, y):
        """Perceptual distance per batch element, `[N]`; inputs NCHW in [-1, 1]."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            a = a / torch.sqrt(a.square().sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(b.square().sum(dim=1, keepdim=True) + 1e-10)
            diff = (a - b).square() * getattr(self, f"lin{i}_w")[None, :, None, None]
            total = total + diff.sum(dim=1).mean(dim=(1, 2))
        return total
