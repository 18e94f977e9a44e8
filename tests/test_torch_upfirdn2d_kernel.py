"""`ops/upfirdn2d.py`'s op as an autograd Function, on the CPU, where it runs
the plain composition (`upfirdn2d_plain`) inside: its gradient and double
gradient (the adjoint the CUDA kernel's backward launches, `up` and `down`
swapped, the filter flipped, the adjoint padding) checked numerically in f64
and against autograd of the plain composition; the launch counter; the
arguments the wrapper hands the C entry; the build.  The kernel has no CPU
mode: the `cuda` test below and chip_smoke.py (phase upfirdn2d) hold it
against the plain composition on the card.

The JAX comparisons of the op's values are test_torch_ops.py's, which now
run through the Function too.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import ctypes
import re

import numpy as np
import pytest
import torch

from pix2pix3d_tpu_torch.ops import cuda_build
from pix2pix3d_tpu_torch.ops import upfirdn2d as fir

# the (up, down, padding) grid and filters of
# test_torch_ops.py::test_upfirdn2d_matches_jax
GRID = [(1, 1, 0), (1, 1, 2), (2, 1, [2, 1, 2, 1]), (1, 2, [1, 1, 1, 1]),
        (2, 2, [3, 2, 3, 2]), (1, 1, [-1, 2, 0, -1]), (4, 1, [3, 1, 3, 1])]
FILTERS = {"none": None, "1331": [1, 3, 3, 1], "121": [1, 2, 1],
           "sep8": [1, 2, 3, 4, 4, 3, 2, 1]}
# flip_filter, gain and the separable filter on a few of the grid's cases
EXTRA = [(2, 1, [2, 1, 2, 1], "1331", True, 4.0), (1, 2, [1, 1, 1, 1], "121", True, 1.0),
         (1, 1, [-1, 2, 0, -1], "1331", False, 2.5), (2, 1, [4, 3, 4, 3], "sep8", False, 4.0),
         (1, 2, [3, 3, 3, 3], "sep8", True, 1.0), (2, 2, [3, 2, 3, 2], "sep8", False, 1.0)]
CASES = ([(u, d, p, name, False, 1.0) for u, d, p in GRID for name in ("none", "1331", "121")]
         + EXTRA)


def _filter(name):
    taps = FILTERS[name]
    return None if taps is None else fir.setup_filter(taps).double()


def _case_id(case):
    up, down, padding, name, flip, gain = case
    return f"up{up}-down{down}-pad{padding}-{name}-flip{int(flip)}-gain{gain}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_the_function_differentiates_as_the_plain_composition(case):
    """gradcheck and gradgradcheck of the Function in f64, and its gradient
    and gradient of a gradient (R1's double backward) equal to autograd of
    `upfirdn2d_plain` through the same cotangents."""
    up, down, padding, name, flip, gain = case
    f = _filter(name)
    kw = dict(up=up, down=down, padding=padding, flip_filter=flip, gain=gain)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 5, 6)).requires_grad_(True)

    def op(t):
        return fir.upfirdn2d(t, f, **kw)

    assert torch.autograd.gradcheck(op, (x,))
    assert torch.autograd.gradgradcheck(op, (x,))

    y = op(x)
    want_y = fir.upfirdn2d_plain(x, f, **kw)
    assert y.grad_fn is not None and "Upfirdn2d" in type(y.grad_fn).__name__
    np.testing.assert_array_equal(y.detach().numpy(), want_y.detach().numpy())
    w = torch.from_numpy(rng.randn(*y.shape)).requires_grad_(True)
    v = torch.from_numpy(rng.randn(*x.shape))
    sides = []
    for forward in (op, lambda t: fir.upfirdn2d_plain(t, f, **kw)):
        gx, = torch.autograd.grad((forward(x) * w).sum(), x, create_graph=True)
        gw, = torch.autograd.grad((gx * v).sum(), w)
        sides.append((gx.detach().numpy(), gw.numpy()))
    for got, want in zip(*sides):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_the_filter_takes_no_gradient():
    f = fir.setup_filter([1, 3, 3, 1]).requires_grad_(True)
    x = torch.randn(1, 1, 4, 4, requires_grad=True)
    y = fir.upfirdn2d(x, f, up=2, padding=[2, 1, 2, 1])
    with pytest.raises(RuntimeError, match="filter takes no gradient"):
        y.sum().backward()


@pytest.mark.parametrize("bad", ["x_ndim", "f_ndim"])
def test_the_op_checks_its_arguments(bad):
    x, f = torch.zeros(1, 1, 4, 4), fir.setup_filter([1, 3, 3, 1])
    if bad == "x_ndim":
        x = x[0]
    else:
        f = f[None]
    with pytest.raises(ValueError):
        fir.upfirdn2d(x, f)


def test_cpu_tensors_launch_nothing():
    """On the CPU the op runs the plain composition: the launch counter
    stays where it was, forward and backward."""
    before = fir.upfirdn2d.launches
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    y = fir.upsample2d(x, fir.setup_filter([1, 3, 3, 1]))
    y = fir.downsample2d(y, fir.setup_filter([1, 3, 3, 1]))
    y.square().sum().backward()
    assert y.shape == x.shape and x.grad is not None
    assert fir.upfirdn2d.launches == before


def _c_entry_types():
    """The C types of `p2p3d_upfirdn2d`'s parameters, from the source."""
    text = cuda_build.source(fir.NAME).read_text()
    m = re.search(r'extern "C" int p2p3d_upfirdn2d\(([^)]*)\)', text)
    assert m, "no C entry p2p3d_upfirdn2d in csrc/upfirdn2d.cu"
    return [" ".join(p.split()[:-1]).replace("const ", "")
            for p in m.group(1).replace("\n", " ").split(",")]


def test_the_wrapper_passes_the_c_entry_its_types():
    """ARGTYPES follows the C signature (pointers as c_void_p, so ctypes does
    not cut them to 32 bits), and `args` gives each a value of its kind:
    pointers and the stream as Python ints (None for no filter), the rest
    ints, the gain a float."""
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "double": ctypes.c_double}
    c_types = _c_entry_types()
    assert [ctype[t] for t in c_types] == fir.ARGTYPES
    x = torch.randn(2, 3, 5, 6)
    f = fir.setup_filter([1, 3, 3, 1])
    y = torch.empty(2, 3, 11, 13)
    for filt in (f, None):
        args = fir.upfirdn2d.args(x, filt, y, (2, 2), (1, 1), (3, 2, 3, 2), True, 4.0,
                                  0x7f0012345678)
        assert len(args) == len(fir.ARGTYPES)
        for t, a in zip(fir.ARGTYPES, args):
            if t is ctypes.c_void_p:
                assert a is None or (isinstance(a, int) and a >= 0)
            elif t is ctypes.c_double:
                assert isinstance(a, float)
            else:
                assert isinstance(a, int) and -2**31 <= a < 2**31
            t(a)
        assert args[:3] == (x.data_ptr(), None if filt is None else f.data_ptr(),
                            y.data_ptr())
        assert args[3:8] == (6, 5, 6, 11, 13) and args[-1] == 0x7f0012345678
        assert args[-3:-1] == (4.0, 0)
        assert args[16] == 0 and args[17] == 1       # separable, flip
    sep = fir.setup_filter([1, 2, 3, 4, 4, 3, 2, 1])
    assert fir.upfirdn2d.args(x.bfloat16(), sep, y.bfloat16(), (1, 1), (1, 1),
                              (0, 0, 0, 0), False, 1.0, 0)[14:17] == (8, 8, 1)
    assert fir.upfirdn2d.args(x.bfloat16(), sep, y, (1, 1), (1, 1), (0, 0, 0, 0),
                              False, 1.0, 0)[-2] == 1


def test_the_kernel_builds_with_the_others_for_sm_90a():
    """The kernel is one of the libraries the first `load` builds at once:
    its source under csrc/, the C entry, and the name every one of its
    device functions holds (benchmark/metrics/upfirdn2d_ms.batch.py finds
    them by it)."""
    assert fir.NAME in cuda_build.KERNELS
    src = cuda_build.source(fir.NAME)
    assert src.is_file() and src.parent == cuda_build.CSRC
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)",
                         src.read_text())
    assert len(kernels) == 3 and all(k.startswith("upfirdn2d_polyphase") for k in kernels)
    lib = cuda_build.library_path(fir.NAME)
    assert lib.parent == cuda_build.BUILD_DIR and lib.name.startswith(f"lib{fir.NAME}_")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """Needs a Hopper card and nvcc; chip_smoke.py runs the same check on
    every call a forward and a training step make."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for up, down, padding, name, flip, gain in CASES:
        taps = FILTERS[name]
        f = None if taps is None else fir.setup_filter(taps, device="cuda")
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8),
                           (torch.float64, 1e-12)):
            x = torch.randn((2, 3, 37, 70), generator=gen, device="cuda").to(dtype)
            kw = dict(up=up, down=down, padding=padding, flip_filter=flip, gain=gain)
            before = fir.upfirdn2d.launches
            got = fir.upfirdn2d(x, f, **kw)
            assert fir.upfirdn2d.launches == before + 1 and got.dtype == dtype
            want = fir.upfirdn2d_plain(x.double(), None if f is None else f.double(), **kw)
            torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)
