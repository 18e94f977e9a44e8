"""The frustum render's texture shears as one call over every image and plane
(`pix2pix3d_tpu_torch/ops/shear_textures.py`), on the CPU, where the wrapper
runs the plain per-texture shears: against JAX's `prepare_textures`, through
the backbone's strided view of the planes, the render's choice between the
wrapper and the differentiable shears, the autograd guard, the argument
checks and the build.  The CUDA kernel has no CPU mode: chip_smoke.py
(phase shear) holds it against the plain version on the card.

Tolerance: test_torch_render.py's TOL, 1e-4 (f32 band-matrix products
summed in another order than JAX's).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pix2pix3d_tpu.render import frustum as jfr

from pix2pix3d_tpu_torch.models.triplane import _reshape_planes
from pix2pix3d_tpu_torch.ops import cuda_build
from pix2pix3d_tpu_torch.ops import shear_textures as st
from pix2pix3d_tpu_torch.render import frustum as tfr

TOL = dict(rtol=1e-4, atol=1e-4)
S, C = 64, 4                      # MARGIN / S = 2
EXT = S + 2 * st.MARGIN
# (a, b, d1, d2, flip) of the 2 x 3 textures: both signs; b at +-MARGIN/S,
# a as far as the pivot of `factor_shears` lets it go (|a| <= 1)
SHEARS = ((0.0, 2.0, 1.1, 0.9, False), (0.37, -2.0, 0.8, -1.2, True),
          (-0.9, 0.3, 1.0, 1.0, False), (0.6, -1.7, -0.7, 1.3, True),
          (-0.25, 1.25, 1.2, 0.8, True), (0.95, -0.05, 0.9, 1.1, False))


def _coeffs(rng):
    """B = Shx(a) Shy(b) diag(d1, d2) per texture, its rows swapped where
    the texture is to be flipped, and random translations."""
    B = []
    for a, b, d1, d2, flip in SHEARS:
        m = np.array([[(1 + a * b) * d1, a * d2], [b * d1, d2]], np.float32)
        B.append(m[::-1] if flip else m)
    return {"B": np.stack(B).reshape(2, 3, 2, 2),
            "E0": rng.randn(2, 3, 2).astype(np.float32),
            "E1": rng.randn(2, 3, 2).astype(np.float32)}


def _factored(co):
    a, b, _, _, _, _, flip = tfr.factor_shears(*(torch.from_numpy(co[k])
                                                 for k in ("B", "E0", "E1")))
    return a, b, flip


def test_the_wrapper_matches_jax_prepare_textures():
    """K = 6 textures with flips on and off and slopes of both signs; where
    |b| = MARGIN/S the first and last output columns' centers all fall off
    the texture and read zero."""
    rng = np.random.RandomState(0)
    planes = rng.randn(2, 3, S, S, C).astype(np.float32)
    co = _coeffs(rng)
    a, b, flip = _factored(co)
    assert flip.reshape(-1).tolist() == [s[4] for s in SHEARS]
    np.testing.assert_allclose(a.reshape(-1).numpy(), [s[0] for s in SHEARS], atol=1e-6)
    np.testing.assert_allclose(b.reshape(-1).numpy(), [s[1] for s in SHEARS], atol=1e-5)
    want = np.asarray(jfr.prepare_textures(
        jnp.asarray(planes), {k: jnp.asarray(v) for k, v in co.items()})["tex"])
    got = st.shear_textures(torch.from_numpy(planes), a, b, flip)
    assert got.shape == (6, EXT, C, EXT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.transpose(2, 3).numpy(), want, **TOL)
    for k, shear in enumerate(SHEARS):
        if abs(shear[1]) == st.MARGIN / S:
            assert got[k].abs().amax() > 0
            assert got[k, :, :, 0].abs().amax() == 0 and got[k, :, :, -1].abs().amax() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_backbone_view_reads_as_a_contiguous_copy(dtype):
    """The render hands the wrapper `_reshape_planes`' view of the
    backbone's [N, 3*C, S, S] memory (channel-planar, x contiguous)."""
    gen = torch.Generator().manual_seed(1)
    view = _reshape_planes(torch.randn((2, 3 * C, S, S), generator=gen), 3, C)
    assert not view.is_contiguous() and view.stride()[3] == 1
    a, b, flip = _factored(_coeffs(np.random.RandomState(1)))
    got = st.shear_textures(view, a, b, flip, dtype)
    want = st.shear_textures(view.contiguous(), a, b, flip, dtype)
    assert got.dtype == dtype and got.shape == (6, EXT, C, EXT)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["no_grad", "grad_mode_planes_fixed", "grad"])
def test_the_render_shears_through_the_wrapper_unless_gradients_flow(mode, monkeypatch):
    """`prepare_textures` makes one wrapper call for all textures, into the
    compute dtype, unless grad mode is on and the planes require grad: then
    the differentiable shears run (f32, with a grad_fn) and the wrapper
    neither runs nor launches."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(args)
        return st.shear_textures(*args, **kwargs)

    monkeypatch.setattr(tfr, "shear_textures", counting)
    rng = np.random.RandomState(2)
    planes = torch.from_numpy(rng.randn(2, 3, S, S, C).astype(np.float32))
    co = {k: torch.from_numpy(v) for k, v in _coeffs(rng).items()}
    planes.requires_grad_(mode == "grad")
    before = st.shear_textures.launches
    with torch.set_grad_enabled(mode != "no_grad"):
        prep = tfr.prepare_textures(planes, co, torch.bfloat16)
    tex = prep["tex"]
    assert tex.shape == (6, EXT, C, EXT)
    assert st.shear_textures.launches == before
    if mode == "grad":
        assert not calls and tex.grad_fn is not None and tex.dtype == torch.float32
        tex.float().square().mean().backward()
        assert torch.isfinite(planes.grad).all() and planes.grad.abs().amax() > 0
    else:
        assert len(calls) == 1 and tex.grad_fn is None and tex.dtype == torch.bfloat16


@pytest.mark.parametrize("which", [0, 1, 2])
def test_the_wrapper_refuses_autograd(which):
    """With grad mode on, planes, a or b requiring grad raises: the kernel
    writes through ctypes what autograd cannot see."""
    rng = np.random.RandomState(3)
    planes = torch.from_numpy(rng.randn(1, 3, 16, 16, 2).astype(np.float32))
    a, b = torch.full((1, 3), 0.1), torch.full((1, 3), -0.2)
    args = [planes, a, b, torch.zeros((1, 3), dtype=torch.bool)]
    args[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        st.shear_textures(*args)
    with torch.no_grad():
        assert st.shear_textures(*args).shape == (3, 16 + 2 * st.MARGIN, 2,
                                                  16 + 2 * st.MARGIN)


@pytest.mark.parametrize("bad", ["a_shape", "flip_dtype", "planes_dtype"])
def test_the_wrapper_checks_its_arguments(bad):
    planes = torch.zeros((1, 3, 16, 16, 2))
    a, b = torch.zeros((1, 3)), torch.zeros((1, 3))
    flip = torch.zeros((1, 3), dtype=torch.bool)
    if bad == "a_shape":
        a, err = torch.zeros(3), ValueError
    elif bad == "flip_dtype":
        flip, err = torch.zeros((1, 3)), TypeError
    else:
        planes, err = planes.half(), TypeError
    with pytest.raises(err):
        st.shear_textures(planes, a, b, flip)


def test_the_kernel_builds_with_the_others_for_sm_90a():
    """The shear kernel is one of the libraries the first `load` builds at
    once: its source under csrc/, the C entry the wrapper loads, and a
    kernel name no other device operation holds (a reader finds it so)."""
    assert st.NAME in cuda_build.KERNELS
    src = cuda_build.source(st.NAME)
    assert src.is_file() and src.parent == cuda_build.CSRC
    text = src.read_text()
    assert "p2p3d_shear_textures" in text and "cubic_shear_textures" in text
    assert "-gencode arch=compute_90a,code=sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    lib = cuda_build.library_path(st.NAME)
    assert lib.parent == cuda_build.BUILD_DIR and lib.name.startswith(f"lib{st.NAME}_")
