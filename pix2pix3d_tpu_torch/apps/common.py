"""Shared inference-app plumbing, port of `pix2pix3d_tpu/apps/common.py`
(ref `applications/generate_samples.py:51-123`).

Config presets mirror the released models (`generate_samples.py:65-73`):
seg2cat / seg2face at neural-render 128, edge2car at 64; fixed focal lengths
from `generate_video.py:127,137`.

The apps run on `device` ("cuda" by default; they raise without a card and
run on the CPU only for `device="cpu"`), under `torch.no_grad()` with TF32
off (`inference()`), as the JAX apps run their f32 products at
`Precision.HIGHEST`.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os

import numpy as np
import torch

from .. import config as cfg_mod
from .. import resolve_device
from ..bridge import params_from_jax, params_to_jax
from ..models import build_generator
from ..ops import precision

APP_PRESETS = {
    "seg2cat": dict(preset="seg2cat", neural_rendering_resolution=128,
                    focal_length=4.2647),
    "seg2face": dict(preset="seg2face", neural_rendering_resolution=128,
                     focal_length=4.2647),
    "edge2car": dict(preset="edge2car", neural_rendering_resolution=64,
                     focal_length=1.7074),
}


def build_app_generator(cfg_name, checkpoint=None, device="cuda", seed=0,
                        **overrides):
    """Build the generator for an app config on `device`, with weights from
    `checkpoint` if given (else random, from `seed`); returns (G, app).

    checkpoint: a reference `.pkl` (converted on load, `utils/convert.py`)
    or a `.ckpt` in the JAX package's msgpack format (`G_ema`, else `G`).
    A `<ckpt>.json` sidecar's `g_config` overrides the preset's
    architecture (and then `overrides` are not used), and the neural
    rendering resolution follows the checkpoint: 128 for an output of 512²
    or more, 64 below.
    """
    app = dict(APP_PRESETS[cfg_name])
    gcfg = None
    if checkpoint and not checkpoint.endswith(".pkl"):
        sidecar = checkpoint + ".json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
            gc = (meta.get("config", meta) or {}).get("g_config")
            if isinstance(gc, str):
                gc = ast.literal_eval(gc)
            if gc:
                gcfg = gc
                app["neural_rendering_resolution"] = \
                    128 if gc["img_resolution"] >= 512 else 64
    if gcfg is None:
        gcfg = cfg_mod.preset_generator_config(app["preset"], **overrides)
    G = build_generator(device=device, seed=seed, **gcfg)
    if checkpoint:
        if checkpoint.endswith(".pkl"):
            from ..utils.convert import convert_state_dict, load_reference_pickle
            modules = load_reference_pickle(checkpoint)
            source = modules.get("G_ema") or modules.get("G")
            tree = convert_state_dict(source, params_to_jax(G))
        else:
            from ..train.checkpoint import load_checkpoint
            state, _ = load_checkpoint(checkpoint)
            tree = state.get("G_ema", state.get("G"))
        G.load_state_dict(params_from_jax(tree), strict=True)
    return G, app


def device_of(G):
    return next(G.parameters()).device


def intrinsics_for(app, device="cuda"):
    f = app["focal_length"]
    return torch.tensor([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]],
                        dtype=torch.float32, device=resolve_device(device))


def draw_z(G, seed, device):
    """z `[1, z_dim]` from `torch.Generator().manual_seed(seed)` (so a seed
    gives another z than in the JAX package, which draws from its PRNG
    key)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, G.z_dim), generator=g).to(device)


def as_f32(x, device):
    """An array or tensor as an f32 tensor on `device` (arrays copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def mask_input(G, mask, device):
    """Raw map `[H, W, 1]` (labels, or an edge image 0..255) -> the
    mapping's `[1, H, W, 1]` float input; edges rescaled to [-1, 1],
    inverted."""
    mask_in = as_f32(mask, device)[None]
    if G.data_type == "edge":
        mask_in = -(mask_in / 127.5 - 1)
    return mask_in


@contextlib.contextmanager
def inference():
    """No autograd, TF32 off."""
    with torch.no_grad(), precision.policy(False):
        yield


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(img):
    """[-1,1] float NHWC -> uint8."""
    return np.clip((to_numpy(img) + 1) * 127.5, 0, 255).astype(np.uint8)
