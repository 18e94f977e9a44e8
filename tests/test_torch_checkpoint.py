"""The port's checkpoint formats against the JAX package's: the flax msgpack
codec (`pix2pix3d_tpu_torch/utils/flax_msgpack.py`), `train/checkpoint.py`,
`bridge.params_to_jax` and the reference-pickle converter
(`utils/convert.py`).

Every comparison is exact: the formats carry bits, and a bf16 leaf widened
to f32 (a 16-bit shift) equals the JAX package's `astype(float32)`.  The
small generator is the one of tests/test_torch_generator.py (cbase 1024,
cmax 32); its tree is `jax.device_get(G.init(PRNGKey(0)))`.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import io
import json
import pickle
import sys
import types
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.train import checkpoint as jckpt
from pix2pix3d_tpu.utils import convert as jconvert
from pix2pix3d_tpu.utils.misc import tree_paths as jtree_paths

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.train import checkpoint as tckpt
from pix2pix3d_tpu_torch.utils import convert as tconvert
from pix2pix3d_tpu_torch.utils import flax_msgpack as fm
from pix2pix3d_tpu_torch.utils.misc import tree_paths

ROOT = Path(__file__).resolve().parent.parent
R5 = ROOT / "docs" / "ckpts_r5" / "seg2cat128_r5_ema.ckpt"


def _small_cfg(cfg_mod):
    cfg = cfg_mod.generator_config(
        cfg="afhq", resolution=128, data_type="seg", semantic_channels=6,
        cbase=1024, cmax=32, sr_num_fp16_res=0, render_mask=True,
        gen_pose_cond=True)
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    return cfg


@pytest.fixture(scope="module")
def trees():
    """(JAX params as numpy, the port's generator holding them)."""
    G = jbuild(**_small_cfg(jconfig))
    params = jax.device_get(jax.jit(G.init)(jax.random.PRNGKey(0)))
    Gt = tbuild(device="cpu", **_small_cfg(tconfig))
    Gt.load_state_dict(bridge.params_from_jax(params), strict=True)
    return params, Gt


def _leaves(tree):
    return dict(tree_paths(tree))


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(k))


def _bf16_widened(tree):
    """The JAX tree rounded to bf16, widened back to f32 (numpy)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)


# --- the codec against flax ------------------------------------------------

SCALARS = {"none": None, "true": True, "false": False, "int": 8000,
           "neg": -5, "int8": -100, "int16": -30000, "int32": -2 ** 31,
           "uint64": 2 ** 63, "float": 1.25, "str": "x" * 40,
           "long_str": "y" * 300, "bytes": b"\x00\x01" * 200,
           "complex": 3 - 4j, "np_f32": np.float32(3.5), "np_i64": np.int64(-7),
           "map16": {f"k{i:02d}": i * 1000 for i in range(20)},
           "array": np.arange(12, dtype=np.float32).reshape(3, 4),
           "empty": np.zeros((0, 3), np.int64), "u8": np.arange(5, dtype=np.uint8),
           "f64_0d": np.array(2.5), "i32_0d": np.array(7, np.int32)}


def test_writer_writes_flax_bytes_and_reads_them_back():
    """The same tree gives the same bytes as flax's `msgpack_serialize`
    (keys sorted as flax's tree copy leaves them), and each reader reads
    the other's."""
    tree = {"state": dict(SCALARS), "step": 3}
    data = fm.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    for back in (fm.msgpack_restore(data), serialization.msgpack_restore(data)):
        for k, v in SCALARS.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(back["state"][k], v)
                assert back["state"][k].dtype == v.dtype
            else:
                assert back["state"][k] == v and type(back["state"][k]) is type(v), k


@pytest.mark.parametrize("bf16", [False, True])
def test_port_reads_the_jax_packages_checkpoint(tmp_path, trees, bf16):
    """JAX `save_checkpoint` (an EMA-only bf16 export as
    scripts/export_ema.py writes it, or f32) -> the port's reader."""
    params, _ = trees
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if bf16 else a, params)
    path = str(tmp_path / "g.ckpt")
    jckpt.save_checkpoint(path, {"G_ema": state}, config={"g_config": {"a": 1}},
                          step=123)
    got, step = tckpt.load_checkpoint(path)
    assert step == 123
    _assert_trees_equal(got["G_ema"], _bf16_widened(params) if bf16 else params)
    ema, step = tckpt.load_ema_params(path)
    assert step == 123 and ema is not None
    want_ema, _ = jckpt.load_ema_params(path)
    _assert_trees_equal(ema, jax.device_get(want_ema))


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_package_reads_the_ports_checkpoint(tmp_path, trees, bf16):
    """The port's `save_checkpoint` of `params_to_jax(G)` (bf16 leaves from
    torch.bfloat16 tensors) -> JAX `load_checkpoint` / `load_ema_params`."""
    params, Gt = trees
    tree = bridge.params_to_jax(Gt)
    if bf16:
        tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(), tree)
    path = str(tmp_path / "g.ckpt")
    tckpt.save_checkpoint(path, {"G_ema": tree}, config={"g_config": {"a": 1}},
                          step=7)
    assert json.loads(Path(path + ".json").read_text()) == {"g_config": {"a": 1}}
    assert not Path(path + ".tmp").exists()
    state, step = jckpt.load_checkpoint(path)
    assert int(step) == 7
    got = jax.device_get(state["G_ema"])
    if bf16:
        assert all(a.dtype == jnp.bfloat16 for a in jax.tree_util.tree_leaves(got))
        want = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                      params)
        _assert_trees_equal(got, want)
    else:
        _assert_trees_equal(got, params)
    ema, _ = jckpt.load_ema_params(path)
    _assert_trees_equal(jax.device_get(ema),
                        _bf16_widened(params) if bf16 else params)


def test_chunked_leaf_is_reassembled(monkeypatch):
    """flax chunks a leaf above MAX_CHUNK_SIZE bytes: the port's reader
    returns the array, never the chunk map; a broken chunk map raises."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    data = serialization.msgpack_serialize({"state": {"w": big, "b": np.ones(3)}})
    assert b"__msgpack_chunked_array__" in data
    got = fm.msgpack_restore(data)["state"]
    assert isinstance(got["w"], np.ndarray)
    np.testing.assert_array_equal(got["w"], big)
    np.testing.assert_array_equal(got["b"], np.ones(3))
    broken = fm.msgpack_serialize({"state": {"w": {
        "__msgpack_chunked_array__": True, "shape": {"0": 4, "1": 25},
        "chunks": {"1": big.reshape(-1)}}}})
    with pytest.raises(ValueError, match="state/w"):
        fm.msgpack_restore(broken)


def test_writer_refuses_a_leaf_that_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="a/w"):
        fm.msgpack_serialize({"a": {"w": np.zeros(100, np.float32)}})


# --- bridge ----------------------------------------------------------------

def test_params_to_jax_inverts_params_from_jax(trees):
    params, Gt = trees
    sd = Gt.state_dict()
    tree = bridge.params_to_jax(Gt)
    back = bridge.params_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    want = {p: np.shape(a) for p, a in jtree_paths(params)}
    got = {p: np.shape(a) for p, a in tree_paths(tree)}
    assert got == want
    _assert_trees_equal(tree, params)


def test_copy_params_fuzzy_matches_jax(trees):
    """Name-matched copy with the `_semantic` fallback, as in JAX."""
    params, _ = trees
    src = {"superresolution": params["superresolution"],
           "decoder": {"net": params["decoder"]["net"]}}
    dst = jax.tree_util.tree_map(np.zeros_like, params)
    got = tckpt.copy_params_fuzzy(src, dst)
    want = jax.device_get(jckpt.copy_params_fuzzy(src, dst))
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(
        got["decoder"]["net_semantic"]["fc0"]["weight"],
        params["decoder"]["net"]["fc0"]["weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.copy_params_fuzzy({"decoder": {"net": {"fc0": {"weight": np.zeros(3)}}}},
                                dst, allow_mismatch=False)


# --- the tree's trained checkpoint -----------------------------------------

def test_trained_r5_checkpoint_reads_as_in_jax():
    """docs/ckpts_r5/seg2cat128_r5_ema.ckpt (an EMA-only export, every leaf
    bf16): the port's `load_ema_params` equals JAX's, leaf for leaf and bit
    for bit."""
    got, step = tckpt.load_ema_params(str(R5))
    want, jstep = jckpt.load_ema_params(str(R5))
    raw, _ = jckpt.load_checkpoint(str(R5))
    stored = jax.tree_util.tree_leaves(raw["G_ema"])
    assert len(stored) == 214
    assert all(a.dtype == jnp.bfloat16 for a in stored)
    assert step == jstep == 8000
    want = jax.device_get(want)
    assert len(list(tree_paths(got))) == 214
    _assert_trees_equal(got, want)


# --- the reference pickle --------------------------------------------------

def _persistence_module():
    """A stand-in `torch_utils.persistence` so that pickle can name
    `_reconstruct_persistent_obj` as the reference's persistence pickles do
    (`persistence.py:37-99`); loading must never call it."""
    tu = types.ModuleType("torch_utils")
    mod = types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):
        raise AssertionError("the loader ran the pickle's reconstructor")
    _reconstruct_persistent_obj.__module__ = mod.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    mod._reconstruct_persistent_obj = _reconstruct_persistent_obj
    tu.persistence = mod
    return tu, mod


class _Persistent:
    """Pickles as a reference persistence object: `_reconstruct_persistent_obj
    (meta)`, `meta['state']` holding `_parameters`, `_buffers`, `_modules`."""

    def __init__(self, reconstruct, name, params, buffers, modules):
        self.reconstruct = reconstruct
        self.meta = dict(type="class", version=6, class_name=name,
                         module_src="raise SystemExit('module source ran')",
                         state=dict(training=False, _parameters=params,
                                    _buffers=buffers, _modules=modules))

    def __reduce__(self):
        return self.reconstruct, (self.meta,)


def _reference_layout(params):
    """The JAX tree as reference state_dict names and layouts (the inverse
    of `convert_state_dict` for a generator)."""
    sd = {}
    for path, leaf in jtree_paths(params):
        v = np.asarray(leaf)
        if path[-1] in ("w_avg", "noise_const"):
            pass
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 3:
            v = v.transpose(2, 0, 1)
        elif v.ndim == 2:
            v = v.T
        sd[jconvert._torch_name(path)] = torch.from_numpy(np.array(v, order="C"))
    return sd


def _module_tree(sd, reconstruct, name="G"):
    params, buffers, children = OrderedDict(), OrderedDict(), {}
    for key, t in sd.items():
        head, _, rest = key.partition(".")
        if rest:
            children.setdefault(head, {})[rest] = t
        elif head in ("w_avg", "noise_const"):
            buffers[head] = t
        else:
            params[head] = torch.nn.Parameter(t, requires_grad=False)
    modules = OrderedDict((k, _module_tree(v, reconstruct, k))
                          for k, v in children.items())
    return _Persistent(reconstruct, name, params, buffers, modules)


def test_reference_pickle_converts_as_in_jax(tmp_path, trees, monkeypatch):
    """A persistence-format pickle of the small generator (as the released
    `.pkl`s hold it) -> the port's `load_reference_pickle` +
    `convert_state_dict` gives JAX's parameters, which equal the source."""
    params, Gt = trees
    tu, mod = _persistence_module()
    monkeypatch.setitem(sys.modules, "torch_utils", tu)
    monkeypatch.setitem(sys.modules, "torch_utils.persistence", mod)
    g = _module_tree(_reference_layout(params), mod._reconstruct_persistent_obj)
    path = tmp_path / "snapshot.pkl"
    with open(path, "wb") as f:
        pickle.dump({"G_ema": g, "training_set_kwargs": {"d": 1}}, f)
    monkeypatch.delitem(sys.modules, "torch_utils.persistence")

    got_sd = tconvert.load_reference_pickle(str(path))["G_ema"]
    want_sd = jconvert.load_reference_pickle(str(path))["G_ema"]
    assert set(got_sd) == set(want_sd)
    assert "backbone.synthesis.b4.conv1.weight" in got_sd
    assert "decoder.net.2.weight" in got_sd
    got = tconvert.convert_state_dict(got_sd, bridge.params_to_jax(Gt))
    want = jax.device_get(jconvert.convert_state_dict(want_sd, params))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    with pytest.raises(KeyError, match="missing parameter"):
        tconvert.convert_state_dict({}, bridge.params_to_jax(Gt))


def test_app_generator_reads_a_reference_pickle(tmp_path, monkeypatch):
    """`build_app_generator` on a `.pkl` (no sidecar: the preset with the
    caller's overrides, here narrowed to 128², cbase 1024, cmax 32) loads
    the same parameters as the JAX package's."""
    from pix2pix3d_tpu.apps import common as jcommon
    from pix2pix3d_tpu_torch.apps import common as tcommon
    over = dict(resolution=128, cbase=1024, cmax=32, sr_num_fp16_res=0)
    G = jbuild(**jconfig.preset_generator_config("seg2cat", **over))
    params = jax.device_get(jax.jit(G.init)(jax.random.PRNGKey(1)))
    tu, mod = _persistence_module()
    monkeypatch.setitem(sys.modules, "torch_utils", tu)
    monkeypatch.setitem(sys.modules, "torch_utils.persistence", mod)
    path = str(tmp_path / "network.pkl")
    with open(path, "wb") as f:
        pickle.dump({"G_ema": _module_tree(_reference_layout(params),
                                           mod._reconstruct_persistent_obj)}, f)
    Gt, app = tcommon.build_app_generator("seg2cat", checkpoint=path,
                                          device="cpu", **over)
    _, jparams, japp = jcommon.build_app_generator("seg2cat", checkpoint=path,
                                                   **over)
    assert app == japp and Gt.img_resolution == 128
    _assert_trees_equal(bridge.params_to_jax(Gt), jax.device_get(jparams))
    _assert_trees_equal(bridge.params_to_jax(Gt), params)


class _EvalPayload:
    def __init__(self, sentinel):
        self.code = f"__import__('pathlib').Path({str(sentinel)!r}).write_text('pwned')"

    def __reduce__(self):
        return eval, (self.code,)


class _LoadFromBytesPayload:
    """A legacy tensor whose storage bytes are an attacker's pickle."""

    def __init__(self, sentinel):
        self.inner = pickle.dumps(_EvalPayload(sentinel))

    def __reduce__(self):
        import torch.storage
        return torch.storage._load_from_bytes, (self.inner,)


@pytest.mark.parametrize("payload", [_EvalPayload, _LoadFromBytesPayload])
def test_restricted_unpickler_blocks_code(tmp_path, payload):
    """As tests/test_pkl_roundtrip.py's `test_restricted_unpickler_blocks_*`:
    a pickle with a code payload runs nothing (raising is allowed)."""
    sentinel = tmp_path / "pwned"
    path = tmp_path / "evil.pkl"
    buf = io.BytesIO()
    pickle.dump({"G": payload(sentinel)}, buf)
    path.write_bytes(buf.getvalue())
    try:
        tconvert.load_reference_pickle(str(path))
    except Exception:
        pass  # refusing the payload is the expected outcome
    assert not sentinel.exists(), "the loader executed the embedded code"
