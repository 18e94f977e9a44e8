"""CPU settings for the port's tests, applied when a tests/test_torch_*.py
module imports this one (every one does; under xdist each worker imports
them all while it collects).

Threads: PyTorch's intra-op pool takes every core by default, so six xdist
workers running the port at once oversubscribe the CPU many times over
(the trainer's tests measured 848 s instead of 260 s so); here each
process gets 2 threads, as `two_torch_threads` gave the trainer's tests.

Heap: the port's CPU forwards make many large temporaries.  One frustum
render of tests/test_torch_noise.py allocates ~20 GB in elementwise
temporaries, most of them in the band-weight construction
(`ops/shear_textures.py` `_cubic_weights`: [lines, out, in] taps, 16-80 MB
each).  With glibc's defaults such a block is a fresh `mmap`, or heap growth
that the next `free` trims back, and the kernel zeroes its pages again on
first touch: that test spent 69 s of system time beside 103 s of user
time.  Here blocks up to 1 GiB come from the heap, which keeps up to 2 GiB
free at its top instead of returning it (glibc's `mallopt`); a process's
resident size then stays near its peak.

Neither changes what a test computes but the order of PyTorch's parallel
reductions, which the tests' tolerances already allow for.
"""

import ctypes
import ctypes.util
import sys

import torch

THREADS = 2

# mallopt parameters (malloc.h)
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
HEAP = ((M_MMAP_THRESHOLD, 1 << 30), (M_TRIM_THRESHOLD, (1 << 31) - 1))


def apply():
    """Set the thread count and, on glibc, the heap thresholds (once)."""
    if getattr(apply, "done", False):
        return
    torch.set_num_threads(THREADS)
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        if hasattr(libc, "mallopt"):
            for param, value in HEAP:
                libc.mallopt(param, value)
    apply.done = True


apply()
