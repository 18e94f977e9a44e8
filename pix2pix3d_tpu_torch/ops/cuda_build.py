"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with a plain C interface.  `build`
compiles it with `nvcc` for sm_90a (Hopper) into
`_build/lib<name>_<hash>.so`, where the hash covers the source, the shared
headers `csrc/*.cuh` and the flags, so an edit rebuilds and an unchanged
tree reuses the library.  Several kernels build at once, one `nvcc` process
each.  `load` builds all of `KERNELS` that are missing and opens the one
asked for with `ctypes`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel of the port: the first `load` builds them all at once
KERNELS = ("decode_composite", "late_separate_decode", "shear_textures", "upfirdn2d")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def source(name):
    return CSRC / f"{name}.cu"


def library_path(name):
    """Where `build(name)` puts the library for the current sources."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build(*names, log=None):
    """Compile each named kernel whose library is missing, all `nvcc`
    processes started together, and return the libraries' paths in order.
    `log(name, output)`, if given, receives each build's nvcc output
    (ptxas's register and shared-memory report)."""
    targets = [library_path(n) for n in names]
    todo = [(n, so) for n, so in zip(names, targets) if not so.exists()]
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            continue
        if log is not None:
            log(name, out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def refuse_autograd(name, *tensors):
    """Raise if grad mode is on and any of `tensors` requires grad: a kernel
    launched through `ctypes` writes outputs that autograd cannot see, so it
    would give no gradient without an error.  The JAX package's
    `pallas_call`s have no VJP either.  Checked on every device, so that the
    CPU (the plain version, which could differentiate) refuses what the card
    would."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "inputs that do not require grad")


def load(name, symbol, argtypes):
    """The C function `symbol` of kernel `name`, with its argument types set
    and an int (cudaError_t) result.  Builds every kernel of `KERNELS` that
    is missing, in one `build` call: a cold tree pays one parallel compile,
    not one serial compile a kernel at its first use."""
    fn = getattr(ctypes.CDLL(str(build(*KERNELS)[KERNELS.index(name)])), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
