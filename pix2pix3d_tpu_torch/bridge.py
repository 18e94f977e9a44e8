"""JAX param tree <-> PyTorch `state_dict` for the port's modules.

Works on numpy arrays only, so it runs without JAX (callers hand it
`jax.device_get(G.init(key))`).  The port names its modules after the JAX
tree's keys, so a leaf at `tree["a"]["b"]["weight"]` becomes the state_dict
entry `a.b.weight`; layouts are inverted on the way:

- conv weights HWIO `[kh, kw, I, O]` -> OIHW `[O, I, kh, kw]`;
- FullyConnected weights `[in, out]` -> `[out, in]`;
- synthesis `const` HWC `[res, res, C]` -> CHW;
- everything else as is (biases, `noise_const` [res, res],
  `noise_strength`, `w_avg`).

`params_to_jax` is the inverse: it nests a module's `state_dict` under the
JAX tree's keys with the JAX layouts, so the port writes checkpoints that
the JAX package reads (`train/checkpoint.py`).
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


def _convert_back(name, t):
    a = t.detach().cpu().numpy()
    if name == "weight" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif name == "weight" and a.ndim == 2:
        a = a.T
    elif name == "const" and a.ndim == 3:
        a = a.transpose(1, 2, 0)
    return np.array(a, order="C")  # C-contiguous, keeps 0-d shapes


def params_to_jax(module_or_state_dict):
    """A module (or its `state_dict`) as the JAX package's nested param tree
    of numpy arrays: OIHW -> HWIO, `[out, in]` -> `[in, out]`, `const` CHW
    -> HWC, everything else as is."""
    sd = module_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    tree = {}
    for path, value in sd.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = _convert_back(key, value)
    return tree
