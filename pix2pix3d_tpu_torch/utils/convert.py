"""Reference-checkpoint conversion, port of `pix2pix3d_tpu/utils/convert.py`:
torch state_dict -> the JAX package's NHWC param tree, in numpy.

Layout transforms:
- Linear `[out, in]`        -> `[in, out]`        (transpose)
- Conv   `[O, I, kh, kw]`   -> `[kh, kw, I, O]`   (permute 2,3,1,0)
- Const  `[C, H, W]`        -> `[H, W, C]`        (permute 1,2,0)
- DiscriminatorEpilogue `fc.weight` additionally permutes its flattened input
  from NCHW (c*16+h*4+w) to NHWC (h*4C+w*C+c) ordering.
- Sequential indices (`net.0`, `net.2`) map to `fc0`, `fc1`.
- Buffers with no pytree analog (resample_filter, alpha) are skipped;
  `noise_const` / `w_avg` / `noise_strength` convert as-is.

The result is a tree in the JAX package's layout, as `G.init` gives it
there; `bridge.params_from_jax` loads it into the port's generator (the
template comes from `bridge.params_to_jax(G)`).

`load_reference_pickle` extracts state_dicts from the released `.pkl`
checkpoints WITHOUT executing the embedded pickled module code (the
reference's `persistence` pickles carry source code; we unpickle with a
restricted loader that materializes tensors only, pattern from the
reference's own `legacy.py:67-71`).
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from .misc import tree_paths


def _to_numpy(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _torch_name(path):
    """Map a pytree path tuple to the reference state_dict name."""
    parts = []
    for i, p in enumerate(path):
        if p.startswith("fc") and i > 0 and path[i - 1] in ("net", "net_semantic"):
            # decoder Sequential: fc0 -> 0, fc1 -> 2 (softplus at index 1)
            parts.append(str(int(p[2:]) * 2))
        else:
            parts.append(p)
    return ".".join(parts)


def convert_state_dict(state_dict, params_template):
    """Convert a torch state_dict into the given pytree template's layout.

    Args:
        state_dict: dict name -> torch tensor / numpy array.
        params_template: nested dicts of numpy arrays with target-shaped
            leaves (e.g. `bridge.params_to_jax(G)`).

    Returns:
        A new pytree with converted values.  Raises KeyError/ValueError on
        missing names or shape mismatches.
    """
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    out = {}
    for path, leaf in tree_paths(params_template):
        name = _torch_name(path)
        if name not in sd:
            raise KeyError(f"missing parameter in state_dict: {name}")
        v = sd[name]
        target_shape = tuple(leaf.shape)

        if path[-1] in ("w_avg", "noise_const", "freqs", "phases", "transform") \
                or path[-2:] == ("input", "weight"):
            # buffers / StyleGAN3 SynthesisInput keep the reference layout
            # (w_avg may be 2D, noise_const is square, input.weight is
            # applied as x @ W.T on both sides)
            pass
        elif v.ndim == 4:
            v = np.transpose(v, (2, 3, 1, 0))
        elif v.ndim == 3:
            v = np.transpose(v, (1, 2, 0))
        elif v.ndim == 2:
            if path[-2:] == ("fc", "weight") and "b4" in path:
                # epilogue flatten reorder: [O, C*R*R] NCHW -> NHWC
                o, cin = v.shape
                in_feats = target_shape[0]
                assert cin == in_feats
                res = 4
                c = cin // (res * res)
                v = v.reshape(o, c, res, res).transpose(0, 2, 3, 1).reshape(o, cin)
            v = v.T
        # 0D / 1D: as-is

        if tuple(v.shape) != target_shape:
            raise ValueError(
                f"shape mismatch for {name}: torch {sd[name].shape} -> {v.shape}, "
                f"expected {target_shape}")
        _set_path(out, path, np.asarray(v, dtype=leaf.dtype))
    return out


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_reference_pickle(path):
    """Extract `{module_name: state_dict}` from a released pix2pix3D `.pkl`.

    Uses a restricted unpickler: the persistence-format pickles contain class
    definitions with embedded source; we substitute inert shell objects for
    every `torch_utils.persistence._reconstruct_persistent_obj` call and any
    unknown class, keeping only tensors and plain containers.  Tensor data
    itself loads through torch's storage loader (CPU).
    """
    class _Shell:
        """Inert stand-in for any blocked class/callable: records constructor
        args, __setstate__ state, and dict items without executing anything."""

        # NOTE: pickle may instantiate via __new__ without __init__
        # (NEWOBJ), so every access defaults lazily.
        def __init__(self, *a, **k):
            self.__dict__["_args"] = a

        def _f(self):
            return self.__dict__.setdefault("_fields", {})

        def __setstate__(self, state):
            if isinstance(state, dict):
                self._f().update(state)
            else:
                self._f()["__state__"] = state

        def __setitem__(self, k, v):
            self._f()[k] = v

        def __getattr__(self, k):
            try:
                return self.__dict__.setdefault("_fields", {})[k]
            except KeyError:
                raise AttributeError(k)

    def _safe_load_from_bytes(b):
        """Safe shim for `torch.storage._load_from_bytes`.

        The torch-internal original is `torch.load(io.BytesIO(b))` WITHOUT
        `weights_only`, i.e. a full unrestricted pickle load — a malicious
        checkpoint could wrap an arbitrary payload in a `_load_from_bytes`
        call and execute code.  Parse the legacy storage bytes through
        torch's hardened weights-only unpickler instead."""
        return torch.load(io.BytesIO(b), weights_only=True)

    class _RestrictedUnpickler(pickle.Unpickler):
        _ALLOW = {
            ("collections", "OrderedDict"),
            ("torch._utils", "_rebuild_tensor_v2"),
            ("torch._utils", "_rebuild_parameter"),
            ("torch", "Size"),
            ("numpy", "ndarray"),
            ("numpy", "dtype"),
            ("numpy.core.multiarray", "_reconstruct"),
            ("numpy.core.multiarray", "scalar"),
            ("_codecs", "encode"),
        }

        def find_class(self, module, name):
            # legacy (non-zip) torch pickles embed tensor data behind this
            # torch-internal byte parser; route through the safe shim
            if (module, name) == ("torch.storage", "_load_from_bytes"):
                return _safe_load_from_bytes
            if (module, name) in self._ALLOW:
                return super().find_class(module, name)
            if module.startswith("torch") and name in (
                    "FloatStorage", "HalfStorage", "LongStorage", "IntStorage",
                    "BoolStorage", "DoubleStorage", "ByteStorage"):
                return super().find_class(module, name)
            return _Shell

        def persistent_load(self, pid):
            raise pickle.UnpicklingError("persistent ids not supported here")

    with open(path, "rb") as f:
        data = f.read()
    # Released pkls are PLAIN pickles of a module dict (the reference's
    # training_loop uses pickle.dump, not torch.save); tensors inside embed
    # torch-format byte blobs restored by torch.storage._load_from_bytes.
    obj = _RestrictedUnpickler(io.BytesIO(data)).load()

    def module_fields(obj):
        """Resolve a (possibly shelled) torch module to its __dict__-like
        state.  Persistence-decorated modules pickle as
        `_reconstruct_persistent_obj(meta)` -> the state lives inside
        `meta['state']`; plain nn.Modules carry it via __setstate__."""
        if isinstance(obj, _Shell):
            args = obj.__dict__.get("_args", ())
            if args:
                meta = args[0]
                m = (meta.__dict__.get("_fields", {})
                     if isinstance(meta, _Shell) else meta)
                if isinstance(m, dict) and "state" in m:
                    state = m["state"]
                    if isinstance(state, _Shell):
                        return state.__dict__.get("_fields", {})
                    if isinstance(state, dict):
                        return state
            return obj.__dict__.get("_fields", {})
        if isinstance(obj, dict):
            return obj
        return {}

    def extract_state(shell, prefix=""):
        out = {}
        fields = module_fields(shell)
        for k, v in fields.items():
            if k in ("_parameters", "_buffers") and isinstance(v, dict):
                for pk, pv in v.items():
                    if pv is not None and hasattr(pv, "shape"):
                        out[prefix + pk] = pv
            elif k == "_modules" and isinstance(v, dict):
                for mk, mv in v.items():
                    out.update(extract_state(mv, prefix + mk + "."))
        return out

    result = {}
    if isinstance(obj, dict):
        for key, val in obj.items():
            state = extract_state(val)
            if state:
                result[key] = state
    return result
