"""PNG encoding in the standard library (`zlib`, `struct`) and numpy.

Pillow is not a dependency of the port, which writes its image grids and
the smoke run's synthetic datasets with this encoder: 8-bit grayscale
(`[H, W]` or `[H, W, 1]`), RGB or RGBA, no interlace, every row with filter
type 0 (None), one IDAT chunk.  Any PNG reader (PIL, the repo's
`native/png_reader.cpp`) decodes it to the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(image, level=6):
    """uint8 `[H, W]` or `[H, W, C]` (C in 1, 3, 4) -> PNG bytes."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"image shape {a.shape} is not [H, W] or [H, W, 1|3|4]")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, image, level=6):
    """Write `image` (see `encode_png`) to `path`."""
    data = encode_png(image, level)
    with open(path, "wb") as f:
        f.write(data)
