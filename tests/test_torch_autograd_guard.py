"""The kernel wrappers refuse autograd: `ops/decode_composite.
fused_decode_composite` and `ops/late_separate_decode.late_separate_decode`
launch their kernels through `ctypes` into outputs autograd cannot see, so
with grad mode on an input that requires grad raises a `RuntimeError`, on
every device (here the CPU, where the plain version could differentiate);
the JAX package's `pallas_call`s have no VJP either.  Under
`torch.no_grad()`, or on inputs that require no grad, the calls run as
before.  chip_smoke.py checks the same on the card.
"""

import numpy as np
import pytest
import torch

from pix2pix3d_tpu_torch.ops import decode_composite as dc
from pix2pix3d_tpu_torch.ops import late_separate_decode as lsd


def _w(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32) * 0.2)


def dc_args():
    """decode_composite's inputs: CH=2 chunks of TC=4 samples, N=1, R=64."""
    feats = _w((2, 1, 4, 32, 64), 0)
    t_vals = torch.linspace(2.25, 3.3, 8)[None]
    dnorm = torch.ones(1, 64)
    w2t = torch.zeros(128, 128)
    w2t[0:32, 0:64] = _w((32, 64), 3)
    w2t[32:65, 64:128] = _w((33, 64), 4)
    return [feats, t_vals, dnorm, _w((128, 32), 1), _w((128, 1), 2), w2t,
            _w((128, 1), 5)]


def lsd_args():
    w2 = torch.zeros(128, 128)
    w2[0:64, 0:32] = _w((64, 32), 3)
    w2[64:128, 32:65] = _w((64, 33), 4)
    return [_w((100, 32), 0), _w((32, 128), 1), _w((1, 128), 2), w2, _w((1, 128), 5)]


CASES = {"decode_composite": (dc.fused_decode_composite, dc_args, 7),
         "late_separate_decode": (lsd.late_separate_decode, lsd_args, 5)}


@pytest.mark.parametrize("name", list(CASES))
def test_the_wrapper_raises_under_autograd(name):
    fn, args, n = CASES[name]
    for i in range(n):
        a = args()
        a[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="has no backward"):
            fn(*a)


@pytest.mark.parametrize("name", list(CASES))
def test_the_wrapper_runs_without_autograd(name):
    fn, args, n = CASES[name]
    want = fn(*args())
    a = args()
    for t in a:
        t.requires_grad_(True)
    with torch.no_grad():
        got = fn(*a)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert not any(x.requires_grad for x in got)
