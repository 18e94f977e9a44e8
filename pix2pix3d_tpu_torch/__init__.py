"""PyTorch/CUDA port of `pix2pix3d_tpu` (the JAX package stays the reference).

Layout mirrors the JAX package (`ops/`, `nn/`, `render/`, `models/`,
`apps/`, `train/checkpoint.py`, `utils/`, `config.py`); internally modules
are `nn.Module`s in NCHW.  Public entry
points take and return the JAX package's layouts (mask `[N, H, W, 1]`,
images `[N, H, W, C]`), run on `cuda` by default, and run on the CPU only
when the caller passes `device="cpu"`.
"""

import torch


def resolve_device(device):
    """`torch.device(device)`; raises if it names a card and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device
