"""The block-diagonal contract of the packed lateSeparate weights, on which the
CUDA kernels (`csrc/late_separate_mlp.cuh`) and their plain versions rely.

`fuse_late_separate_params(_t)` packs the decoder's two 32 -> 64 -> 33 MLPs
into W1 [32, 128] and a W2 [128, 128] whose only nonzero entries lie in
W2[0:64, 0:32] (rgb features) and W2[64:128, 32:65] (semantic features and
sigma).  The kernels read only those two blocks, and so do
`late_separate_decode_plain` and `decode_composite_plain`: here the rest of
W2 is filled with NaN and the outputs must not change by one bit.  With
those poisoned weights the plain versions are also held against the JAX
Pallas kernels (interpreter, zeros outside the blocks) at the tolerances of
tests/test_torch_late_separate.py (f32 2e-5; bf16 8e-3 per element plus
2e-4 RMS) and tests/test_torch_decode_composite.py (f32 1e-5; bf16 1e-3 plus
5e-6 RMS).  Weights come from the JAX decoder's `init` through
`bridge.params_from_jax`.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.models.triplane import OSGDecoderSemanticLateSeparate as JDecoder
from pix2pix3d_tpu.ops.decoder_pallas import fuse_late_separate_params as jfuse
from pix2pix3d_tpu.ops.decoder_pallas import late_separate_decode as jdecode
from pix2pix3d_tpu.ops.render_pallas import fuse_late_separate_params_t as jfuse_t
from pix2pix3d_tpu.ops.render_pallas import fused_decode_composite as jcomposite

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
from pix2pix3d_tpu_torch.ops import decode_composite as dc
from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd


def _live():
    """Mask of W2's live blocks, [hidden, out]."""
    live = torch.zeros((128, 128), dtype=torch.bool)
    live[:64, :32] = True
    live[64:, 32:65] = True
    return live


def _decoder(sem_sigmoid, lr_mul, seed):
    opts = {"decoder_output_dim": 32, "decoder_lr_mul": lr_mul,
            "sigmoid": sem_sigmoid}
    jd, td = JDecoder(32, opts), OSGDecoderSemanticLateSeparate(32, opts)
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed))
    td.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return params, td.eval()


def _poisoned(w2, transposed):
    """W2 (or W2ᵀ) with NaN everywhere outside the live blocks."""
    live = _live().t() if transposed else _live()
    return torch.where(live, w2, torch.full_like(w2, float("nan")))


@pytest.mark.parametrize("lr_mul", [1.0, 0.5])
def test_fused_params_are_block_diagonal(lr_mul):
    _, td = _decoder(True, lr_mul, 0)
    _, _, w2, _ = dc.fuse_late_separate_params(td, lr_mul)
    _, _, w2t, _ = dc.fuse_late_separate_params_t(td, lr_mul)
    live = _live()
    assert torch.equal(w2t, w2.t())
    assert (w2[~live] == 0).all()
    # every live entry holds a weight, sigma's column too
    assert (w2[live] != 0).all()
    assert (w2[64:, 64] != 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_late_separate_plain_reads_only_the_live_blocks(dtype, sem_sigmoid):
    params, td = _decoder(sem_sigmoid, 1.0, 1)
    x = np.random.RandomState(2).randn(4096, 32).astype(np.float32)
    w1, b1, w2, b2 = dc.fuse_late_separate_params(td, 1.0)
    cd = getattr(torch, dtype)
    kw = dict(rgb_sigmoid=True, sem_sigmoid=sem_sigmoid, compute_dtype=cd)
    clean = lsd.late_separate_decode_plain(torch.from_numpy(x), w1, b1, w2, b2, **kw)
    got = lsd.late_separate_decode_plain(torch.from_numpy(x), w1, b1,
                                         _poisoned(w2, False), b2, **kw)
    for a, b in zip(got, clean):
        assert torch.equal(a, b)
    colors, sigma = jdecode(jnp.asarray(x), *jfuse(params, 1.0), rgb_sigmoid=True,
                            sem_sigmoid=sem_sigmoid, compute_dtype=getattr(jnp, dtype),
                            interpret=True)
    want = (np.asarray(colors.astype(jnp.float32)), np.asarray(sigma))
    tol = 2e-5 if dtype == "float32" else 8e-3
    for a, b in zip(got, want):
        a = a.float().numpy()
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        if dtype == "bfloat16":
            assert np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)) <= 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_decode_composite_plain_reads_only_the_live_blocks(dtype, sem_sigmoid):
    params, td = _decoder(sem_sigmoid, 1.0, 3)
    rng = np.random.RandomState(4)
    feats = rng.randn(4, 1, 8, 32, 128).astype(np.float32)
    t_vals = np.sort(rng.rand(1, 32).astype(np.float32) * 2 + 2, axis=1)
    dnorm = (1 + 0.1 * rng.rand(1, 128)).astype(np.float32)
    w1t, b1, w2t, b2 = dc.fuse_late_separate_params_t(td, 1.0)
    args = (torch.from_numpy(feats).to(getattr(torch, dtype)),
            torch.from_numpy(t_vals), torch.from_numpy(dnorm))
    clean = dc.decode_composite_plain(*args, w1t, b1, w2t, b2, sem_sigmoid=sem_sigmoid)
    got = dc.decode_composite_plain(*args, w1t, b1, _poisoned(w2t, True), b2,
                                    sem_sigmoid=sem_sigmoid)
    for a, b in zip(got, clean):
        assert torch.equal(a, b)
    want = jcomposite(jnp.asarray(feats), jnp.asarray(t_vals), jnp.asarray(dnorm),
                      *jfuse_t(params, 1.0), rgb_sigmoid=True, sem_sigmoid=sem_sigmoid,
                      compute_dtype=getattr(jnp, dtype), interpret=True)
    tol = 1e-5 if dtype == "float32" else 1e-3
    sq_err = n_el = 0.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)
        sq_err += float(np.sum((a.numpy().astype(np.float64) - np.asarray(b)) ** 2))
        n_el += a.numel()
    if dtype == "bfloat16":
        assert np.sqrt(sq_err / n_el) <= 5e-6
