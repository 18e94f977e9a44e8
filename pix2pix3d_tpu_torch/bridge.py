"""JAX param tree -> PyTorch `state_dict` for the port's modules.

Works on numpy arrays only, so it runs without JAX (callers hand it
`jax.device_get(G.init(key))`).  The port names its modules after the JAX
tree's keys, so a leaf at `tree["a"]["b"]["weight"]` becomes the state_dict
entry `a.b.weight`; layouts are inverted on the way:

- conv weights HWIO `[kh, kw, I, O]` -> OIHW `[O, I, kh, kw]`;
- FullyConnected weights `[in, out]` -> `[out, in]`;
- synthesis `const` HWC `[res, res, C]` -> CHW;
- everything else as is (biases, `noise_const` [res, res],
  `noise_strength`, `w_avg`).
"""

from __future__ import annotations

import numpy as np
import torch


def _convert(name, a):
    a = np.asarray(a, dtype=np.float32)
    if name == "weight" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif name == "weight" and a.ndim == 2:
        a = a.T
    elif name == "const" and a.ndim == 3:
        a = a.transpose(2, 0, 1)
    return torch.from_numpy(a.copy())  # C-contiguous, keeps 0-d shapes


def params_from_jax(tree, prefix=""):
    """Flatten a nested dict of numpy arrays into a converted state_dict."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(params_from_jax(value, prefix=path + "."))
        else:
            out[path] = _convert(key, value)
    return out
