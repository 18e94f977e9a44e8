"""Matmul/conv precision policy, port of `pix2pix3d_tpu/ops/precision.py`.

Two settings matter on the GPU:

- parity: float32 tensors with TF32 OFF for both `torch.backends.cuda.matmul`
  and `torch.backends.cudnn` (cuDNN convolutions default to TF32), so that
  f32 results stay comparable with the JAX package at `Precision.HIGHEST`;
- serving: the blocks that `num_fp16_res` / `sr_num_fp16_res` /
  `encoder_num_fp16_res` select hold bf16 tensors (f32 accumulation inside
  cuDNN and cuBLAS), and the remaining f32 convs/matmuls may use TF32 -- the
  counterpart of the JAX package's `fast_f32(True)` (one bf16 MXU pass).

`sr_sem_precision` keeps the semantic SR stack's ACTIVATIONS f32 (its blocks
run with `force_fp32`); its level maps to TF32 on ("default", "high") or
off ("highest") inside `scope`.
"""

from __future__ import annotations

import contextlib

import torch

_TF32_BY_LEVEL = {"default": True, "high": True, "highest": False}


@contextlib.contextmanager
def policy(fast_f32):
    """Set TF32 for f32 matmuls and convolutions to `fast_f32` for the
    duration of the block (both backends), restoring the old values."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(fast_f32)
    torch.backends.cudnn.allow_tf32 = bool(fast_f32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def scope(level):
    """Policy for a stack pinned to `level` ("default" | "high" | "highest");
    `None` leaves the current policy as it is."""
    if level is None:
        return contextlib.nullcontext()
    return policy(_TF32_BY_LEVEL[level])
