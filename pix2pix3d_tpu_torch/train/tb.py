"""Dependency-free TensorBoard event writer, port of
`pix2pix3d_tpu/train/tb.py` (ref `training_loop.py:391-394,772-779`).

It hand-encodes the two protobuf messages TensorBoard reads (Event
{wall_time, step, summary} and Summary.Value {tag, simple_value | image}),
framed as TFRecords (length, masked CRC32C of the length, payload, masked
CRC32C of the payload).  Images are PNGs from the port's own encoder
(`utils/png.py`): Pillow is not a dependency of the port, so an image
record holds other PNG bytes than the JAX writer's for the same pixels.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from ..utils.png import encode_png


# ---------------------------------------------------------------- crc32c
def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _summary_scalar(tag: str, value: float) -> bytes:
    v = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, v)  # Summary.value (repeated field 1)


def _summary_image(tag: str, png_bytes: bytes, h: int, w: int) -> bytes:
    img = (_field_varint(1, h) + _field_varint(2, w) + _field_varint(3, 3)
           + _field_bytes(4, png_bytes))
    v = _field_bytes(1, tag.encode()) + _field_bytes(4, img)
    return _field_bytes(1, v)


def _event(step: int, summary: bytes = b"", file_version: str = "") -> bytes:
    out = _field_double(1, time.time()) + _field_varint(2, int(step))
    if file_version:
        out += _field_bytes(3, file_version.encode())
    if summary:
        out += _field_bytes(5, summary)
    return out


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


# --------------------------------------------------------------- writer
class TBWriter:
    """Append-only TensorBoard event file in `log_dir`."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, name)
        self._f = open(self._path, "ab")
        self._f.write(_record(_event(0, file_version="brain.Event:2")))
        self._f.flush()

    @property
    def path(self):
        return self._path

    def add_scalar(self, tag, value, step):
        self._f.write(_record(_event(step, _summary_scalar(tag, value))))

    def add_scalars(self, fields: dict, step: int):
        summary = b"".join(_summary_scalar(k, v) for k, v in fields.items()
                           if v == v)  # skip NaN
        self._f.write(_record(_event(step, summary)))
        self._f.flush()

    def add_image(self, tag, image_hwc_uint8, step):
        """image: numpy uint8 [H, W, 3]."""
        h, w = image_hwc_uint8.shape[:2]
        self._f.write(_record(_event(
            step, _summary_image(tag, encode_png(image_hwc_uint8), h, w))))
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
