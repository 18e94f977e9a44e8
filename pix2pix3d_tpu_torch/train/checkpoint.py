"""Checkpoints in the JAX package's format, port of
`pix2pix3d_tpu/train/checkpoint.py`.

A checkpoint is flax's msgpack encoding (`utils/flax_msgpack.py`) of
`{"state": tree, "step": step}` with a `<path>.json` sidecar holding the
config; the trees are nested dicts of numpy arrays in the JAX package's
layout (`bridge.params_to_jax` makes one from a port module,
`bridge.params_from_jax` loads one into it).  So the JAX package reads what
this module writes, and the other way round.

A full training checkpoint holds G, D, G_ema, D_semantic and each network's
optax Adam state (`opt_<name>`: `{"0": {count, mu, nu}, "1": {}}`, the
`to_state_dict` form of `optax.adam`'s state); `Trainer.state_tree()` makes
one and `Trainer.load_state_tree` loads one, so a run resumes in either
package.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils import flax_msgpack
from ..utils.misc import tree_paths


def save_checkpoint(path, state, config=None, step=None):
    """Write `{"state": state, "step": step}` to a temporary file, move it
    into place with `os.replace`, then write the `.json` sidecar if
    `config` is given.  Leaves: numpy arrays, or torch tensors
    (`torch.bfloat16` ones are written as bf16)."""
    payload = {"state": state}
    if step is not None:
        payload["step"] = step
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        flax_msgpack.msgpack_dump(payload, f)
    os.replace(tmp, path)
    if config is not None:
        with open(path + ".json", "w") as f:
            json.dump(config, f, indent=2, default=str)


def _match_template(state, template, path=()):
    """`state` checked against `template` (same keys, leaf shapes) with
    each leaf cast to the template leaf's dtype, as flax's
    `from_state_dict(template, state)` restores the JAX package's."""
    if isinstance(template, dict):
        if not isinstance(state, dict) or set(state) != set(template):
            raise ValueError(f"checkpoint tree at {'/'.join(path) or '<root>'} "
                             f"has keys {sorted(state) if isinstance(state, dict) else state!r}, "
                             f"the template {sorted(template)}")
        return {k: _match_template(state[k], template[k], path + (k,))
                for k in template}
    t = np.asarray(template)
    a = np.asarray(state)
    if a.shape != t.shape:
        raise ValueError(f"checkpoint leaf {'/'.join(path)} has shape {a.shape}, "
                         f"the template {t.shape}")
    return a.astype(t.dtype, copy=False)


def load_checkpoint(path, state_template=None):
    """(state tree, step or None); bf16 leaves come back widened to f32.
    With `state_template` (e.g. `Trainer.state_tree()`), the tree must have
    the template's keys and leaf shapes, and leaves take its dtypes."""
    with open(path, "rb") as f:
        payload = flax_msgpack.msgpack_restore(f.read())
    state = payload["state"]
    if state_template is not None:
        state = _match_template(state, state_template)
    return state, payload.get("step")


def load_ema_params(path):
    """G_ema params from a full training checkpoint (`state.G_ema`) or an
    EMA-only export (`G_ema`, `scripts/export_ema.py`), with bf16-stored
    leaves as f32 (the reader widens them exactly)."""
    state, step = load_checkpoint(path)
    ema = state["G_ema"] if "G_ema" in state else state["state"]["G_ema"]
    return ema, step


def copy_params_fuzzy(src_tree, dst_tree, allow_mismatch=True, verbose=False):
    """Name-matched partial init (ref `misc.py:157-176`): copy every leaf of
    `src_tree` whose path exists in `dst_tree` with a matching shape; paths
    containing a `*_semantic` component fall back to the non-semantic name
    in `src_tree` (so EG3D pickles seed both branches)."""
    src = {p: v for p, v in tree_paths(src_tree)}

    def lookup(path):
        if path in src:
            return src[path]
        stripped = tuple(p.replace("_semantic", "") for p in path)
        return src.get(stripped)

    copied = [0]

    def walk(dst, prefix=()):
        if isinstance(dst, dict):
            return {k: walk(v, prefix + (k,)) for k, v in dst.items()}
        v = lookup(prefix)
        if v is not None and tuple(np.shape(v)) == tuple(dst.shape):
            copied[0] += 1
            return np.asarray(v, dst.dtype)
        if v is not None and not allow_mismatch:
            raise ValueError(f"shape mismatch at {'.'.join(prefix)}")
        return dst

    out = walk(dst_tree)
    if verbose:
        print(f"copy_params_fuzzy: copied {copied[0]} leaves")
    return out
