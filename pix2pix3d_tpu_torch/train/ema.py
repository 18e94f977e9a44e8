"""Generator EMA, port of `pix2pix3d_tpu/train/ema.py` (ref
`training_loop.py:549-559`), on `nn.Module`s in place."""

from __future__ import annotations

import torch

# buffers the reference copies into G_ema verbatim instead of averaging
BUFFER_NAMES = ("w_avg", "noise_const")


def ema_beta(batch_size, cur_nimg, ema_kimg, ema_rampup=0.05):
    """Per-step EMA decay with optional ramp-up (host-side floats)."""
    ema_nimg = ema_kimg * 1000
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(G_ema, G, beta):
    """Every parameter and buffer of `G_ema`'s state: ema = p + (ema - p) *
    beta, as the JAX package lerps every leaf of its tree."""
    src = G.state_dict()
    for name, e in G_ema.state_dict().items():
        p = src[name]
        e.copy_(p + (e - p) * torch.tensor(beta, dtype=p.dtype))


@torch.no_grad()
def copy_buffers(G_ema, G, buffer_names=BUFFER_NAMES):
    """Copy the `buffer_names` leaves verbatim (ref `training_loop.py:557-559`)."""
    src = G.state_dict()
    for name, e in G_ema.state_dict().items():
        if name.split(".")[-1] in buffer_names:
            e.copy_(src[name])
