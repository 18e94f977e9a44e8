"""The port's lateSeparate decode kernel (`pix2pix3d_tpu_torch/ops/late_separate_decode.py`)
and the decoder's `impl="kernel"`.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX kernel `late_separate_decode(..., interpret=True)` (the
Pallas interpreter).  The CUDA kernel itself is compared with the plain
version by chip_smoke.py on the card, and by the `cuda`-marked test here
where a card is present.

Tolerances:
- f32 at 2e-5, the JAX suite's own gate for this kernel against the
  reference decoder (tests/test_decoder_pallas.py).
- bf16 at 8e-3 per element (allclose, rtol = atol) plus 2e-4 on the
  root-mean-square error of colors and of sigma, each.  Both sides round h,
  the colors and sigma to bf16 in the same places, so they differ only
  where a sum taken in another order flips one bf16 rounding: one bf16 ulp,
  at most 7.8e-3 for values under 2.  At the importance path's chunk
  (65,536 rows; `test_bf16_gate_separates_reorderings_from_skipped_casts`,
  `pytest -s` prints the numbers) the JAX kernel against the plain version
  takes at most 0.56 of the per-element gate and reads RMS <= 1.8e-5
  (colors) and 4.9e-5 (sigma).  A version that skips the cast of h reads
  RMS >= 8.8e-4 (colors) and 2.8e-3 (sigma), one that skips the cast of
  sigma 1.7e-3 (sigma); the per-element gate alone would pass both (0.86
  and 0.32 of it), the RMS gate fails both by 4x or more.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.models.triplane import OSGDecoderSemanticLateSeparate as JDecoder
from pix2pix3d_tpu.ops.decoder_pallas import fuse_late_separate_params as jfuse
from pix2pix3d_tpu.ops.decoder_pallas import late_separate_decode as jkernel

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
from pix2pix3d_tpu_torch.ops import cuda_build
from pix2pix3d_tpu_torch.ops import decode_composite as dc
from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd
from pix2pix3d_tpu_torch.ops.bias_act import softplus

F32_TOL = 2e-5
BF16_TOL, BF16_RMS = 8e-3, 2e-4


def _decoders(sem_sigmoid, lr_mul, seed):
    opts = {"decoder_output_dim": 32, "decoder_lr_mul": lr_mul,
            "sigmoid": sem_sigmoid}
    jd = JDecoder(32, opts)
    td = OSGDecoderSemanticLateSeparate(32, opts)
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed))
    td.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return jd, params, td.eval()


def _feats(m, seed):
    return np.random.RandomState(seed).randn(m, 32).astype(np.float32)


def _jax(params, lr_mul, x, rgb_sigmoid, sem_sigmoid, dtype):
    colors, sigma = jkernel(jnp.asarray(x), *jfuse(params, lr_mul),
                            rgb_sigmoid=rgb_sigmoid, sem_sigmoid=sem_sigmoid,
                            compute_dtype=dtype, interpret=True)
    return (torch.from_numpy(np.array(colors.astype(jnp.float32))),
            torch.from_numpy(np.array(sigma)))


def _bf16_errors(got, want):
    """(largest share of the allclose(8e-3) bound, RMS colors, RMS sigma)."""
    used, rms = 0.0, []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        used = max(used, (err / (BF16_TOL * (1 + w.float().abs()))).max().item())
        rms.append(err.double().pow(2).mean().sqrt().item())
    return used, rms[0], rms[1]


@pytest.mark.parametrize("m", [600, 4096])
@pytest.mark.parametrize("lr_mul", [1.0, 0.5])
@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_plain_matches_jax_kernel_f32(m, lr_mul, sem_sigmoid):
    _, params, td = _decoders(sem_sigmoid, lr_mul, 0)
    x = _feats(m, 1)
    want = _jax(params, lr_mul, x, True, sem_sigmoid, jnp.float32)
    got = lsd.late_separate_decode(
        torch.from_numpy(x), *dc.fuse_late_separate_params(td, lr_mul),
        rgb_sigmoid=True, sem_sigmoid=sem_sigmoid, compute_dtype=torch.float32)
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (m, 64)
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == (m, 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("rgb_sigmoid,sem_sigmoid", [(False, False), (False, True),
                                                     (True, False), (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_switches(dtype, rgb_sigmoid, sem_sigmoid):
    """Both clamp switches, f32 and bf16 (bf16 gated per element and RMS)."""
    _, params, td = _decoders(sem_sigmoid, 1.0, 2)
    x = _feats(4096, 3)
    want = _jax(params, 1.0, x, rgb_sigmoid, sem_sigmoid, getattr(jnp, dtype))
    got = lsd.late_separate_decode(
        torch.from_numpy(x), *dc.fuse_late_separate_params(td, 1.0),
        rgb_sigmoid=rgb_sigmoid, sem_sigmoid=sem_sigmoid,
        compute_dtype=getattr(torch, dtype))
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    if dtype == "float32":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL,
                                       atol=F32_TOL)
        return
    used, rms_c, rms_s = _bf16_errors(got, want)
    assert used <= 1.0 and rms_c <= BF16_RMS and rms_s <= BF16_RMS, \
        (used, rms_c, rms_s)


def _skipping(x, w1, b1, w2, b2, sem_sigmoid, skip):
    """The plain version with one bf16 cast left out (`skip` 'h' or
    'sigma')."""
    bf = torch.bfloat16
    h = softplus(x.to(bf).float() @ w1.to(bf).float() + b1)
    if skip != "h":
        h = h.to(bf).float()
    o = h @ w2.to(bf).float() + b2
    col = torch.arange(128)
    use = (col < 32) | ((col >= 32) & (col < 64) & sem_sigmoid)
    act = torch.where(use, torch.sigmoid(o) * 1.002 - 0.001, o)
    sigma = act[:, 64:65] if skip == "sigma" else act[:, 64:65].to(bf).float()
    return act[:, :64].to(bf), sigma


@pytest.mark.parametrize("version", ["jax_kernel", "skip_h", "skip_sigma"])
@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_bf16_gate_separates_reorderings_from_skipped_casts(version, sem_sigmoid):
    """At the importance path's chunk (65,536 rows) the bf16 gate passes the
    JAX kernel against the plain version (the same roundings, sums in
    another order) and fails, by 4x or more in RMS, a version that leaves
    out the cast of h or of sigma.  `pytest -s` prints the errors."""
    _, params, td = _decoders(sem_sigmoid, 1.0, 4)
    x = _feats(65536, 5)
    w = dc.fuse_late_separate_params(td, 1.0)
    want = lsd.late_separate_decode(torch.from_numpy(x), *w,
                                    sem_sigmoid=sem_sigmoid,
                                    compute_dtype=torch.bfloat16)
    if version == "jax_kernel":
        got = _jax(params, 1.0, x, True, sem_sigmoid, jnp.bfloat16)
    else:
        got = _skipping(torch.from_numpy(x), *w, sem_sigmoid, version[5:])
    used, rms_c, rms_s = _bf16_errors(got, want)
    print(f"{version} sem_sigmoid={sem_sigmoid}: {used:.3f} of the per-element "
          f"gate, RMS colors {rms_c:.3e} sigma {rms_s:.3e}")
    if version == "jax_kernel":
        assert used <= 1.0 and max(rms_c, rms_s) <= BF16_RMS, (used, rms_c, rms_s)
    else:
        assert max(rms_c, rms_s) > 4 * BF16_RMS, (used, rms_c, rms_s)


@pytest.mark.parametrize("sem_sigmoid", [False, True])
def test_decoder_kernel_impl_matches_ref_and_jax(sem_sigmoid):
    """The port's decoder with impl='kernel' (its plain version on the CPU)
    against its impl='ref' and against the JAX decoder's impl='ref', f32."""
    jd, params, td = _decoders(sem_sigmoid, 1.0, 6)
    feats = np.random.RandomState(7).randn(2, 3, 300, 32).astype(np.float32)
    before = lsd.late_separate_decode.launches
    with torch.no_grad():
        got = td(torch.from_numpy(feats), None, impl="kernel")
        ref = td(torch.from_numpy(feats), None)
    assert lsd.late_separate_decode.launches == before   # CPU: plain version
    want = jd(params, jnp.asarray(feats), None)
    for key, shape in (("rgb", (2, 300, 64)), ("sigma", (2, 300, 1))):
        assert tuple(got[key].shape) == shape
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_decoder_rejects_an_unknown_impl():
    _, _, td = _decoders(False, 1.0, 0)
    with pytest.raises(ValueError):
        td(torch.zeros((1, 3, 4, 32)), None, impl="pallas")


def _small_args():
    g = torch.Generator().manual_seed(0)
    return [torch.randn((300, 32), generator=g),
            torch.randn((32, 128), generator=g) / 32 ** 0.5,
            torch.zeros((1, 128)),
            torch.randn((128, 128), generator=g) / 128 ** 0.5,
            torch.zeros((1, 128))]


@pytest.mark.parametrize("bad", ["feats_rank", "channels", "dtype", "w1", "b2",
                                 "compute_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = _small_args()
    kw = {}
    if bad == "feats_rank":
        args[0] = args[0][None]
    elif bad == "channels":
        args[0] = args[0][:, :16]
    elif bad == "dtype":
        args[0] = args[0].half()
    elif bad == "w1":
        args[1] = args[1][:, :64]
    elif bad == "b2":
        args[4] = args[4].reshape(128)
    else:
        kw["compute_dtype"] = torch.float16
    with pytest.raises((ValueError, TypeError)):
        lsd.late_separate_decode(*args, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_without_counting(dtype):
    before = lsd.late_separate_decode.launches
    args = _small_args()
    got = lsd.late_separate_decode(*args, sem_sigmoid=True, compute_dtype=dtype)
    want = lsd.late_separate_decode_plain(*args, sem_sigmoid=True,
                                          compute_dtype=dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert lsd.late_separate_decode.launches == before


@pytest.mark.parametrize("name", [dc.NAME, lsd.NAME])
def test_kernels_build_from_csrc_for_sm_90a(name):
    """Both wrappers build through the shared helper: an existing source
    under csrc/, nvcc flags for sm_90a, a library path keyed by a hash of
    the sources (nvcc itself runs only on the card's machine)."""
    src = cuda_build.source(name)
    assert src.is_file() and src.parent == cuda_build.CSRC
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    lib = cuda_build.library_path(name)
    assert lib.parent == cuda_build.BUILD_DIR and lib.name.startswith(f"lib{name}_")
    assert "p2p3d_" + name in src.read_text()   # the C entry the wrapper loads


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """Needs a Hopper card and nvcc; chip_smoke.py runs the same check at
    the importance path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for dtype in (torch.float32, torch.bfloat16):
        args = [a.cuda() for a in _small_args()]
        before = lsd.late_separate_decode.launches
        got = lsd.late_separate_decode(*args, sem_sigmoid=True, compute_dtype=dtype)
        assert lsd.late_separate_decode.launches == before + 1
        want = lsd.late_separate_decode_plain(*args, sem_sigmoid=True,
                                              compute_dtype=dtype)
        if dtype == torch.float32:
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
        else:
            used, rms_c, rms_s = _bf16_errors(got, want)
            assert used <= 1.0 and max(rms_c, rms_s) <= BF16_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_takes_a_misaligned_view(dtype):
    """A contiguous view that starts one element into its storage, off the
    words the kernel reads rows in, gives the plain version's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    args = [a.cuda() for a in _small_args()]
    feats = args[0].to(dtype)
    view = torch.empty(feats.numel() + 1, dtype=dtype, device="cuda")[1:]
    view = view.view(feats.shape)
    view.copy_(feats)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = lsd.late_separate_decode(view, *args[1:], compute_dtype=dtype)
    want = lsd.late_separate_decode_plain(feats, *args[1:], compute_dtype=dtype)
    if dtype == torch.float32:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        used, rms_c, rms_s = _bf16_errors(got, want)
        assert used <= 1.0 and max(rms_c, rms_s) <= BF16_RMS
