"""The benchmark's CPU tests: the harness, the reference and the result line
at tiny sizes.  Tests marked `cuda` run on a card and skip elsewhere.

The port's CPU renders make many large temporaries: as in the port's own
tests (tests/torch_cpu.py), blocks up to 1 GiB come from the heap, which
keeps up to 2 GiB free at its top, and each process takes 4 threads."""

import ctypes
import ctypes.util
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(4)
if sys.platform.startswith("linux"):
    _libc = ctypes.CDLL(ctypes.util.find_library("c"))
    if hasattr(_libc, "mallopt"):
        _libc.mallopt(-3, 1 << 30)          # M_MMAP_THRESHOLD
        _libc.mallopt(-1, (1 << 31) - 1)    # M_TRIM_THRESHOLD


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
