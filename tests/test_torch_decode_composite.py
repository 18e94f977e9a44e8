"""The port's fused decode+composite (`pix2pix3d_tpu_torch/ops/decode_composite.py`).

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX kernel `fused_decode_composite(..., interpret=True)` (the
Pallas interpreter) and against the port's own unfused frustum composite.
The CUDA kernel itself is compared with the plain version by chip_smoke.py
on the card, and by the `cuda`-marked test here where a card is present.

Tolerances: f32 at 1e-5 (the JAX suite's own gate between its two fused
grids, tests/test_render_pallas.py::test_chunk_grid_matches_slab_grid);
bf16 compute at 1e-3 on every element plus 5e-6 on the root-mean-square
error.  Both sides round h (and, without carry_f32, the colors) to bf16 in
the same places, so they differ only where a sum taken in another order
flips one rounding: measured here at most 5.1e-5 per element and 9.1e-7
RMS.  A version that skips one of those casts differs everywhere: 5.8e-5 to
1.4e-4 RMS at these inputs, which the RMS gate fails by 10x or more; the
per-element gate alone would let it through.  Fused vs unfused frustum
render at 1e-4, as tests/test_render_pallas.py holds the JAX pair.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.models.triplane import OSGDecoderSemanticLateSeparate as JDecoder
from pix2pix3d_tpu.ops.decoder_pallas import fuse_late_separate_params as jfuse
from pix2pix3d_tpu.ops.render_pallas import (fuse_late_separate_params_t as jfuse_t,
                                             fused_decode_composite as jkernel)
from pix2pix3d_tpu.render import camera as jcam
from pix2pix3d_tpu.render import frustum as jfr

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
from pix2pix3d_tpu_torch.ops import decode_composite as dc
from pix2pix3d_tpu_torch.render import frustum as tfr

T, R, N, CHUNK = 48, 256, 2, 8


def _decoders(sem_sigmoid, seed):
    jd = JDecoder(32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
                       "sigmoid": sem_sigmoid})
    td = OSGDecoderSemanticLateSeparate(
        32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
             "sigmoid": sem_sigmoid})
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed))
    td.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return jd, params, td.eval()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(T // CHUNK, N, CHUNK, 32, R).astype(np.float32)
    t_vals = np.sort(rng.rand(N, T).astype(np.float32) * 2 + 2, axis=1)
    dnorm = (1 + 0.1 * rng.rand(N, R)).astype(np.float32)
    return feats, t_vals, dnorm


def test_fused_params_match_jax():
    jd, params, td = _decoders(False, 0)
    for a, b in zip(dc.fuse_late_separate_params(td, 1.0), jfuse(params, 1.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(dc.fuse_late_separate_params_t(td, 1.0), jfuse_t(params, 1.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry_f32", [False, True])
@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_plain_matches_jax_kernel(dtype, carry_f32, sem_sigmoid):
    jd, params, td = _decoders(sem_sigmoid, 1)
    feats, t_vals, dnorm = _inputs(2)
    jw = jfuse_t(params, 1.0)
    want = jkernel(jnp.asarray(feats), jnp.asarray(t_vals), jnp.asarray(dnorm), *jw,
                   rgb_sigmoid=True, sem_sigmoid=sem_sigmoid,
                   compute_dtype=getattr(jnp, dtype), carry_f32=carry_f32,
                   interpret=True)
    tw = dc.fuse_late_separate_params_t(td, 1.0)
    got = dc.fused_decode_composite(
        torch.from_numpy(feats).to(getattr(torch, dtype)), torch.from_numpy(t_vals),
        torch.from_numpy(dnorm), *tw, sem_sigmoid=sem_sigmoid,
        carry_f32=carry_f32)
    tol = 1e-5 if dtype == "float32" else 1e-3
    sq_err = n_el = 0.0
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)
        sq_err += float(np.sum((a.numpy().astype(np.float64) - np.asarray(b)) ** 2))
        n_el += a.numel()
    if dtype == "bfloat16":
        assert np.sqrt(sq_err / n_el) <= 5e-6


@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_fused_render_matches_unfused(sem_sigmoid):
    """The kernel's plain version inside `frustum_render` against the
    port's unfused decode_chunk/composite_step path (the kernel's second
    witness)."""
    _, _, td = _decoders(sem_sigmoid, 3)
    c2w = jcam.LookAtPoseSampler.sample(None, np.pi / 2 + 0.2, np.pi / 2 - 0.1,
                                        [0.0, 0.0, -0.06], radius=2.7, batch_size=2)
    intr = np.tile(np.asarray(jcam.fov_to_intrinsics(18.837))[None], (2, 1, 1))
    planes = torch.randn((2, 3, 64, 64, 32), generator=torch.Generator().manual_seed(0))
    opts = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
            "depth_resolution": 24, "depth_resolution_importance": 24}
    c2w, intr = torch.from_numpy(np.array(c2w)), torch.from_numpy(intr)
    fused = (*dc.fuse_late_separate_params_t(td, 1.0), sem_sigmoid)
    with torch.no_grad():
        ref = tfr.frustum_render(planes, td, c2w, intr, opts, 16, depth_steps=48,
                                 chunk=8)
        got = tfr.frustum_render(planes, None, c2w, intr, opts, 16, depth_steps=48,
                                 chunk=8, fused_decoder=fused)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_jax_fused_render_matches_port():
    """The whole fused frustum render, JAX (Pallas interpreter) vs port."""
    jd, params, td = _decoders(False, 4)
    c2w = jcam.LookAtPoseSampler.sample(None, np.pi / 2 - 0.2, np.pi / 2 + 0.1,
                                        [0.0, 0.0, -0.06], radius=2.7, batch_size=1)
    intr = jnp.tile(jcam.fov_to_intrinsics(18.837)[None], (1, 1, 1))
    planes = np.array(jax.random.normal(jax.random.PRNGKey(6), (1, 3, 64, 64, 32)))
    opts = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
            "depth_resolution": 24, "depth_resolution_importance": 24,
            "fused_carry_f32": True}
    want = jfr.frustum_render(jnp.asarray(planes), None, c2w, intr, opts, 16,
                              depth_steps=48, chunk=16,
                              fused_decoder=(*jfuse_t(params, 1.0), True, False))
    with torch.no_grad():
        got = tfr.frustum_render(torch.from_numpy(planes), None,
                                 torch.from_numpy(np.array(c2w)),
                                 torch.from_numpy(np.array(intr)), opts, 16,
                                 depth_steps=48, chunk=16,
                                 fused_decoder=(*dc.fuse_late_separate_params_t(td, 1.0),
                                                False))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def _small_args(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    feats = torch.randn((2, 1, 4, 32, 64), generator=g).to(dtype)
    return (feats, torch.rand((1, 8), generator=g) + 2, torch.ones((1, 64)),
            torch.randn((128, 32), generator=g) / 32 ** 0.5, torch.zeros((128, 1)),
            torch.randn((128, 128), generator=g) / 128 ** 0.5, torch.zeros((128, 1)))


@pytest.mark.parametrize("bad", ["feats_rank", "channels", "dtype", "t_vals",
                                 "w2t", "t_vals_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = list(_small_args())
    if bad == "feats_rank":
        args[0] = args[0][0]
    elif bad == "channels":
        args[0] = args[0][:, :, :, :16]
    elif bad == "dtype":
        args[0] = args[0].half()
    elif bad == "t_vals":
        args[1] = args[1][:, :4]
    elif bad == "w2t":
        args[5] = args[5][:64]
    else:
        args[1] = args[1].double()
    with pytest.raises((ValueError, TypeError)):
        dc.fused_decode_composite(*args)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dc.fused_decode_composite.launches
    args = _small_args()
    got = dc.fused_decode_composite(*args, sem_sigmoid=True)
    want = dc.decode_composite_plain(*args, sem_sigmoid=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert dc.fused_decode_composite.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """Needs a Hopper card and nvcc; chip_smoke.py runs the same check at
    the main-path shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        args = [a.cuda() for a in _small_args(dtype)]
        before = dc.fused_decode_composite.launches
        got = dc.fused_decode_composite(*args, sem_sigmoid=True)
        assert dc.fused_decode_composite.launches == before + 1
        want = dc.decode_composite_plain(*args, sem_sigmoid=True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
