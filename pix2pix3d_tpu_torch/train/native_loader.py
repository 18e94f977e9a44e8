"""ctypes bindings for the repo's native data path (`native/png_reader.cpp`),
port of `pix2pix3d_tpu/train/native_loader.py`.

The port decodes every PNG of a dataset with this library (Pillow is not
a dependency of the port).  At first use `g++` builds the source from `native/`
(`-O3 -shared -fPIC -lz -lpthread`, as `native/Makefile` does) into the
port's `_build/libpng_reader_<hash>.so`, where the hash covers the source
and the flags; `native/` itself is only read.  A failed build raises with
the compiler's output, and a PNG the decoder does not take (16-bit,
interlaced) raises: there is no second decoder to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "png_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lz", "-lpthread"]

_lib = None


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libpng_reader_{h.hexdigest()[:16]}.so"


def build():
    """Compile the decoder if its library is missing; returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.p2p3d_decode_png.restype = ctypes.c_int
        lib.p2p3d_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.p2p3d_edge_preprocess.restype = None
        lib.p2p3d_edge_preprocess.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


def png_size(data):
    """(width, height) from a PNG's IHDR chunk."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def decode_png(data: bytes):
    """Decode a PNG blob -> HWC uint8 array (8-bit gray, gray+alpha, RGB,
    RGBA or palette, which becomes RGB)."""
    lib = _load()
    w0, h0 = png_size(data)
    cap = w0 * h0 * 4
    out = np.empty(cap, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.p2p3d_decode_png(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                              cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"PNG not decodable by {SOURCE.name} (error {rc}: "
                         "only 8-bit, non-interlaced PNGs are read)")
    return out[:h.value * w.value * c.value].reshape(h.value, w.value, c.value).copy()


def edge_preprocess(mask_gray: np.ndarray):
    """Invert + 3x3 box blur, reflect-101 borders (the edge-map step of
    `ImageEdgeFolderDataset`)."""
    lib = _load()
    h, w = mask_gray.shape
    src = np.ascontiguousarray(mask_gray, np.uint8)
    out = np.empty((h, w), np.uint8)
    lib.p2p3d_edge_preprocess(src.tobytes(), out.ctypes.data_as(ctypes.c_void_p), h, w)
    return out
