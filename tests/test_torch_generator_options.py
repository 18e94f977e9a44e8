"""The generator's `rendering_kwargs` that the port honours as the JAX package
does, or refuses: `frustum_window`, `frustum_tiles`, `sr_sem_f32`,
`decoder_impl`.

The generator is tests/test_torch_generator.py's small frustum configuration
(128^2, 48 depth slabs in chunks of 16, f32 render, nrr 32), here with
`sr_num_fp16_res 4` so that the SR stacks hold bf16 tensors and
`sr_sem_f32` has something to change.  Weights are bridged from
`G.init(PRNGKey(0))`; the JAX side decodes through its Pallas kernel
(interpreter), the port through `fused_decode_composite`'s plain version.

Tolerance 1e-4 on the outputs that are f32 on both sides (image_raw,
image_depth, semantic_raw, and semantic when its stack runs at f32), as in
tests/test_torch_generator.py.  The rgb SR output `image` comes from bf16
blocks, whose rounding the two frameworks do not share: it is compared
only between runs of the port.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild

from test_torch_generator import _request, _small_cfg

F32_OUTPUTS = ("image_raw", "image_depth", "semantic_raw")
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(cfg_mod):
    cfg = _small_cfg(cfg_mod)
    cfg["sr_num_fp16_res"] = 4
    return cfg


@pytest.fixture(scope="module")
def generators():
    G = jbuild(**_cfg(jconfig))
    G.rendering_kwargs["decoder_impl"] = "pallas"
    params = jax.jit(G.init)(jax.random.PRNGKey(0))
    Gt = tbuild(device="cpu", **_cfg(tconfig))
    Gt.rendering_kwargs["decoder_impl"] = "kernel"
    Gt.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return G, params, Gt


@pytest.fixture
def rk(generators):
    """Both generators' rendering_kwargs, restored after the test."""
    G, _, Gt = generators
    saved = dict(G.rendering_kwargs), dict(Gt.rendering_kwargs)
    yield G.rendering_kwargs, Gt.rendering_kwargs
    for live, old in zip((G.rendering_kwargs, Gt.rendering_kwargs), saved):
        live.clear()
        live.update(old)


def _run_jax(G, params, req, jit=False):
    """JAX's forward, eager, or jitted where the eager path dispatches many
    small ops (the tiled render: its jitted forward takes about half the
    time of its eager one here)."""
    z, mask, pose = req

    def forward(params, z, pose, mask):
        return G(params, z, pose, {"mask": mask, "pose": pose},
                 neural_rendering_resolution=32, noise_mode="const", det=True)

    out = (jax.jit(forward) if jit else forward)(
        params, jnp.asarray(z), jnp.asarray(pose), jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(Gt, req):
    z, mask, pose = req
    with torch.no_grad():
        out = Gt(torch.from_numpy(z), torch.from_numpy(pose),
                 {"mask": torch.from_numpy(mask), "pose": torch.from_numpy(pose)},
                 neural_rendering_resolution=32, noise_mode="const")
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("window,poisoned", [((256, 256), False), ((48, 48), True)])
def test_frustum_window_reaches_the_render(generators, rk, window, poisoned):
    """A narrow window that covers every tap gives JAX's render; one that
    misses taps NaN-poisons the render on both sides (the coverage
    guard)."""
    G, params, Gt = generators
    rk[0]["frustum_window"] = rk[1]["frustum_window"] = window
    req = _request(np.pi / 2 + 0.15, np.pi / 2 - 0.1, 0)
    want, got = _run_jax(G, params, req), _run_port(Gt, req)
    for key in F32_OUTPUTS:
        assert np.isnan(want[key]).all() == poisoned, key
        assert np.isnan(got[key]).all() == poisoned, key
        if not poisoned:
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_sr_sem_f32_runs_the_semantic_stack_at_f32(generators, rk):
    G, params, Gt = generators
    req = _request(np.pi / 2 - 0.3, np.pi / 2 + 0.2, 1)
    bf16 = _run_port(Gt, req)["semantic"]
    rk[0]["sr_sem_f32"] = rk[1]["sr_sem_f32"] = True
    want, got = _run_jax(G, params, req), _run_port(Gt, req)
    for key in F32_OUTPUTS + ("semantic",):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    # the flag is the "highest" level of sr_sem_precision, and it matters here
    rk[1].pop("sr_sem_f32")
    rk[1]["sr_sem_precision"] = "highest"
    np.testing.assert_array_equal(_run_port(Gt, req)["semantic"], got["semantic"])
    assert np.abs(bf16 - got["semantic"]).max() > 1e-3


def test_decoder_impl_pallas_is_the_kernel(generators, rk):
    _, _, Gt = generators
    req = _request(np.pi / 2, np.pi / 2, 2)
    kernel = _run_port(Gt, req)
    rk[1]["decoder_impl"] = "pallas"
    pallas = _run_port(Gt, req)
    for key in F32_OUTPUTS + ("image", "semantic"):
        np.testing.assert_array_equal(pallas[key], kernel[key], err_msg=key)


def test_decoder_impl_ref_is_unfused(generators, rk):
    _, _, Gt = generators
    req = _request(np.pi / 2, np.pi / 2, 2)
    rk[1]["decoder_impl"] = None
    unfused = _run_port(Gt, req)
    rk[1]["decoder_impl"] = "ref"
    ref = _run_port(Gt, req)
    for key in F32_OUTPUTS + ("image", "semantic"):
        np.testing.assert_array_equal(ref[key], unfused[key], err_msg=key)


@pytest.mark.parametrize("tiles,poisoned", [((8, 160, 8, 160, 448), False),
                                            ((8, 96, 8, 96, 256), True)])
def test_frustum_tiles_reach_the_render(generators, rk, tiles, poisoned):
    """Per-output-tile windows that cover every tap give JAX's render
    through the fused decode+composite; ones that miss taps NaN-poison the
    render (the tiled coverage guard, held against JAX's in
    tests/test_torch_render.py; JAX's render is compared where it is
    finite).  Chunks of 16 of 48 slabs span three times the depth of the
    serving chunks, so the tiles that cover the serving geometry (nrr//4,
    96, nrr//4, 96, 256) miss taps here."""
    G, params, Gt = generators
    rk[0]["frustum_tiles"] = rk[1]["frustum_tiles"] = tiles
    req = _request(np.pi / 2 + 0.15, np.pi / 2 - 0.1, 0)
    got = _run_port(Gt, req)
    want = None if poisoned else _run_jax(G, params, req, jit=True)
    for key in F32_OUTPUTS:
        assert np.isnan(got[key]).all() == poisoned, key
        if not poisoned:
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("key,value,error,match", [
    ("decoder_impl", "cuda", ValueError, "decoder_impl"),
    ("decoder_impl", "triton", ValueError, "decoder_impl"),
])
def test_unported_rendering_kwargs_raise(generators, rk, key, value, error, match):
    _, _, Gt = generators
    rk[1][key] = value
    with pytest.raises(error, match=match):
        _run_port(Gt, _request(np.pi / 2, np.pi / 2, 3))
