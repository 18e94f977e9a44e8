"""LPIPS over a VGG16 trunk, plain: a frozen copy of the program's
`train/lpips.py` forward, NCHW, f32.

    d(x, y) = sum_l  mean_hw( sum_c w_l,c * (phi_l(x)^ - phi_l(y)^)^2 )

phi_l are the five conv blocks' activations, ^ the unit normalization over
channels, w_l the 1x1 "lin" weights.  The weights are the program's module's
buffers as they are (`load_state_dict` of its `state_dict()`): the tree
ships no published LPIPS weights, and the program draws a fixed random VGG,
so the reference holds no rule of its own for them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# VGG16's (out_channels, convolutions) per block
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        idx, in_ch = 0, 3
        for out_ch, n_convs in VGG_BLOCKS:
            for _ in range(n_convs):
                self.register_buffer(f"conv{idx}_w", torch.zeros(out_ch, in_ch, 3, 3))
                self.register_buffer(f"conv{idx}_b", torch.zeros(out_ch))
                in_ch = out_ch
                idx += 1
        for i, (out_ch, _) in enumerate(VGG_BLOCKS):
            self.register_buffer(f"lin{i}_w", torch.zeros(out_ch))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def features(self, x):
        x = (x - self.shift) / self.scale
        feats, idx = [], 0
        for block, (_, n_convs) in enumerate(VGG_BLOCKS):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{idx}_w"),
                                    getattr(self, f"conv{idx}_b"), padding=1))
                idx += 1
            feats.append(x)
            if block < len(VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, x, y):
        """The distance of each pair, `[N]`; inputs NCHW in [-1, 1]."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            a = a / torch.sqrt(a.square().sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(b.square().sum(dim=1, keepdim=True) + 1e-10)
            diff = (a - b).square() * getattr(self, f"lin{i}_w")[None, :, None, None]
            total = total + diff.sum(dim=1).mean(dim=(1, 2))
        return total
