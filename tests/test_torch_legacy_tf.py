"""The port's legacy TensorFlow pickle converter (`pix2pix3d_tpu_torch/utils
/legacy_tf.py`) against the JAX package's (`pix2pix3d_tpu/utils/legacy_tf.py`).

The pickles are the in-memory StyleGAN2-ADA (G, D, Gs) tuples of
tests/test_legacy_tf.py (16², 32 channels; skip G, resnet D), plus two
variants built from them: a progressive-growing one whose top-level
`ToRGB_lod0` / `FromRGB_lod0` variables make both networks "orig", and one
whose D is "skip" (a FromRGB at every resolution and in the epilogue).

The kwargs and every converted leaf must equal JAX's exactly (the same
numpy arithmetic on the same arrays).  The converted G_ema and D then run in
both packages, f32: within 1e-4 (rtol = atol), the JAX suite's tolerance
for the StyleGAN2 networks (tests/test_parity_torch.py).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import copy
import io
import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn.discriminator import Discriminator as JD
from pix2pix3d_tpu.nn.synthesis import Generator as JG
from pix2pix3d_tpu.train.checkpoint import load_checkpoint as jload
from pix2pix3d_tpu.utils import legacy_tf as jlegacy
from pix2pix3d_tpu.utils.misc import tree_paths as jtree_paths

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.nn.discriminator import Discriminator as TD
from pix2pix3d_tpu_torch.nn.synthesis import Generator as TG
from pix2pix3d_tpu_torch.utils import legacy_tf as tlegacy

import test_legacy_tf as base

TOL = dict(rtol=1e-4, atol=1e-4)


def _pickle(g_state, d_state, gs_state):
    """A (G, D, Gs) TF pickle of the three states, as tests/test_legacy_tf.py
    builds one."""
    Network = base._install_fake_tflib()

    def wrap(state):
        obj = Network.__new__(Network)
        comps = {}
        for k, v in state["components"].items():
            c = Network.__new__(Network)
            c.__dict__.update(v)
            comps[k] = c
        obj.__dict__.update(dict(state, components=comps))
        return obj

    try:
        return pickle.dumps((wrap(g_state), wrap(d_state), wrap(gs_state)))
    finally:
        base._rm_fake_tflib()


def _states():
    rng = np.random.RandomState(0)
    g = base._tf_generator_state(rng)
    d = base._tf_discriminator_state(rng)
    gs = base._tf_generator_state(np.random.RandomState(1))
    return g, d, gs


def _orig_states():
    """Progressive growing: a top-level ToRGB_lod0 in G and Gs, D's FromRGB
    stored per lod."""
    g, d, gs = _states()
    rng = np.random.RandomState(2)
    for s in (g, gs):
        s["variables"] = s["variables"] + [
            ("ToRGB_lod0/weight", rng.randn(1, 1, base.CH, 3).astype(np.float32)),
            ("ToRGB_lod0/bias", rng.randn(3).astype(np.float32))]
    d["variables"] = [(n.replace(f"{base.RES}x{base.RES}/FromRGB", "FromRGB_lod0"), v)
                      for n, v in d["variables"]]
    return g, d, gs


def _skip_d_states():
    """D with architecture "skip": a FromRGB at 8² and in the epilogue."""
    g, d, gs = _states()
    rng = np.random.RandomState(3)
    d["static_kwargs"] = dict(d["static_kwargs"], architecture="skip")
    for r in (8, 4):
        d["variables"] = d["variables"] + [
            (f"{r}x{r}/FromRGB/weight", rng.randn(1, 1, 3, base.CH).astype(np.float32)),
            (f"{r}x{r}/FromRGB/bias", rng.randn(base.CH).astype(np.float32))]
    return g, d, gs


PICKLES = {"skip-resnet": _states, "orig": _orig_states, "skip-skip": _skip_d_states}


@pytest.fixture(scope="module", params=sorted(PICKLES))
def converted(request):
    """(name, pickle bytes, JAX's networks, the port's networks)."""
    buf = _pickle(*PICKLES[request.param]())
    return (request.param, buf, jlegacy.load_legacy_tf_networks(io.BytesIO(buf)),
            tlegacy.load_legacy_tf_networks(io.BytesIO(buf)))


def test_kwargs_and_every_leaf_equal_jax(converted):
    name, _, want, got = converted
    assert set(got) == set(want) == {"G", "D", "G_ema"}
    for net in want:
        (wk, wtree), (gk, gtree) = want[net], got[net]
        assert gk == wk, net
        wleaves = {p: np.asarray(v) for p, v in jtree_paths(wtree)}
        gleaves = dict(jtree_paths(gtree))
        assert gleaves.keys() == wleaves.keys(), net
        for p in wleaves:
            assert gleaves[p].dtype == wleaves[p].dtype, (net, p)
            np.testing.assert_array_equal(gleaves[p], wleaves[p], err_msg=str((net, p)))
    arch = {"skip-resnet": ("skip", "resnet"), "orig": ("orig", "orig"),
            "skip-skip": ("skip", "skip")}[name]
    assert (got["G"][0]["architecture"], got["D"][0]["architecture"]) == arch


def test_converted_networks_match_jax(converted):
    _, _, want, got = converted
    g_kwargs, g_tree = want["G_ema"]
    jg = JG(**g_kwargs)
    tg = TG(**got["G_ema"][0])
    tg.load_state_dict(bridge.params_from_jax(got["G_ema"][1]), strict=True)
    z = np.random.RandomState(4).randn(2, base.W_DIM).astype(np.float32)
    jimg = jax.jit(lambda p, z: jg(p, z, None, noise_mode="const"))(
        jax.tree_util.tree_map(jnp.asarray, g_tree), jnp.asarray(z))
    with torch.no_grad():
        timg = tg(torch.from_numpy(z), None, noise_mode="const")
    assert timg.shape == (2, 3, base.RES, base.RES)
    np.testing.assert_allclose(timg.numpy(), np.transpose(np.asarray(jimg), (0, 3, 1, 2)),
                               **TOL)

    d_kwargs, d_tree = want["D"]
    jd = JD(**d_kwargs)
    td = TD(**got["D"][0])
    td.load_state_dict(bridge.params_from_jax(got["D"][1]), strict=True)
    jlogits = jax.jit(lambda p, x: jd(p, x, None))(
        jax.tree_util.tree_map(jnp.asarray, d_tree), jimg)
    with torch.no_grad():
        tlogits = td(timg, None)
    assert tlogits.shape == (2, 1)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)


def test_rejects_low_version():
    buf, _, _ = base._make_tf_pickle()
    g, _, _ = tlegacy.load_tf_pickle(io.BytesIO(buf))
    g.state["version"] = 3
    with pytest.raises(ValueError, match="version too low"):
        tlegacy.convert_tf_generator(g)


def test_rejects_unknown_kwarg():
    buf, _, _ = base._make_tf_pickle()
    g, d, _ = tlegacy.load_tf_pickle(io.BytesIO(buf))
    g.state["static_kwargs"]["totally_new_option"] = 1
    with pytest.raises(ValueError, match="unknown TensorFlow kwarg"):
        tlegacy.convert_tf_generator(g)
    d.state = copy.deepcopy(d.state)
    d.state["static_kwargs"]["another_option"] = 1
    with pytest.raises(ValueError, match="unknown TensorFlow kwarg"):
        tlegacy.convert_tf_discriminator(d)


def test_loader_is_restricted():
    class Evil:
        def __reduce__(self):
            return (eval, ("1+1",))

    buf = pickle.dumps((Evil(), Evil(), Evil()))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tlegacy.load_tf_pickle(io.BytesIO(buf))
    with pytest.raises(ValueError, match="not a legacy TF network pickle"):
        tlegacy.load_tf_pickle(io.BytesIO(pickle.dumps((1, 2))))


def test_main_writes_a_checkpoint_the_jax_package_reads(tmp_path, converted, capsys):
    name, buf, want, _ = converted
    src, dest = tmp_path / "old.pkl", tmp_path / "new.ckpt"
    src.write_bytes(buf)
    tlegacy.main(["--source", str(src), "--dest", str(dest)])
    assert "Done." in capsys.readouterr().out
    state, step = jload(str(dest))
    assert step == 0 and set(state) == {"G", "D", "G_ema"}
    for net, (kwargs, tree) in want.items():
        leaves = dict(jtree_paths(state[net]))
        for p, v in jtree_paths(tree):
            np.testing.assert_array_equal(np.asarray(leaves[p]), np.asarray(v),
                                          err_msg=str((net, p)))
    with open(str(dest) + ".json") as f:
        sidecar = json.load(f)
    assert sidecar == json.loads(json.dumps({k: v[0] for k, v in want.items()},
                                            default=str))
