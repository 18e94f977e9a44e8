"""Fused bias + activation + gain + clamp (ref `torch_utils/ops/bias_act.py`;
JAX counterpart `pix2pix3d_tpu/ops/bias_act.py`).

Plain PyTorch: on the GPU these elementwise ops are memory-bound glue around
cuDNN convolutions, as they were XLA-fused glue on the TPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class _ActSpec:
    func: Callable
    def_alpha: float
    def_gain: float


_SQRT2 = math.sqrt(2.0)


def softplus(x):
    """`log(1 + exp(x))` as `jax.nn.softplus` computes it (no threshold).
    `max(x, 0)` is written `(x + |x|) / 2`, the same values, so that the
    gradient at x = 0 is 1/2 as JAX's (`clamp_min` would give 1 there, and
    the decoder's first layer sits exactly at 0 for every point outside the
    planes while its bias is still 0)."""
    return (x + x.abs()) * 0.5 + torch.log1p(torch.exp(-x.abs()))


def leaky_relu(x, alpha):
    """`jax.nn.leaky_relu`: x where x >= 0, else alpha * x; the gradient at
    x = 0 is 1, as JAX's (`F.leaky_relu`'s is alpha there)."""
    return torch.where(x >= 0, x, x * alpha)


activation_funcs = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, _SQRT2),
    "lrelu": _ActSpec(leaky_relu, 0.2, _SQRT2),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, alpha: softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, _SQRT2),
}


def bias_act(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
    """Add bias along `dim`, apply activation, scale by gain, clamp.

    Default `dim=1` (NCHW), as in the reference; the JAX package's default
    is -1 because it is channels-last."""
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be >= 0, got {clamp}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        if b.ndim != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias {tuple(b.shape)} does not match dim {dim} "
                             f"of {tuple(x.shape)}")
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
