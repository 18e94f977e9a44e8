"""Reader and writer for the msgpack format of flax's checkpoints, in the
standard library and numpy.

The JAX package saves its checkpoints with flax's `msgpack_serialize` and
reads them with `msgpack_restore` (`pix2pix3d_tpu/train/checkpoint.py`).
That format is a msgpack map of maps whose leaves are
- maps, arrays, str, bin, ints, floats, nil and bool;
- extension type 1, an ndarray: a nested msgpack array `(shape, dtype name,
  C-order bytes)`;
- extension type 3, a numpy scalar, packed as a 0-d ndarray;
- extension type 2, a complex number, a nested msgpack array `(real, imag)`.

bf16 leaves (`scripts/export_ema.py` writes them under the dtype name
"bfloat16") are read as uint16 and widened to float32 by shifting each value
left 16 bits: exact, and the same values as the JAX package's
`astype(float32)`.  numpy has no bf16 type, so this reader returns every bf16
leaf as float32.  To write a bf16 leaf, pass a `torch.bfloat16` tensor.

flax splits a leaf larger than `MAX_CHUNK_SIZE` bytes into a chunk map
(`__msgpack_chunked_array__`); the reader reassembles it, the writer refuses
such a leaf.  The writer sorts map keys as flax's writer leaves them (a
`jax.tree_util` copy of the tree), so for the same tree it writes the same
bytes.

Arrays are read with `memoryview` and `np.frombuffer`: a leaf is a read-only
view into the bytes it was read from (bf16 leaves are new arrays).
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# --- reading ---------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw=False):
        self.buf = memoryview(data)
        self.pos = 0
        # raw: str as bytes and bin as a memoryview (the inner ndarray
        # encoding, whose buffer np.frombuffer then reads in place)
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _FIXED:
            return _FIXED[t]
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _LENGTHS:
            kind, fmt = _LENGTHS[t]
            n = self.unpack(fmt)
            if kind == "bin":
                view = self.take(n)
                return view if self.raw else bytes(view)
            if kind == "str":
                return self.str_(n)
            if kind == "ext":
                return self.ext(n)
            return self.array(n) if kind == "array" else self.map(n)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from_bytes(data):
    """flax's `_ndarray_from_bytes`, with bf16 widened to float32."""
    shape, name, buffer = _Reader(data, raw=True).value()
    if isinstance(name, memoryview):
        name = bytes(name)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16)
        arr = (bits.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(name.decode()))
    return arr.reshape(shape, order="C")


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(data).value()
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _unchunk(tree, path=()):
    """Reassemble flax's chunked leaves (`flax.serialization._unchunk`)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        try:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"chunked leaf {'/'.join(map(str, path))!r} "
                             f"cannot be reassembled: {e}") from e
    return {k: _unchunk(v, path + (k,)) for k, v in tree.items()}


def msgpack_restore(data):
    """The tree that flax's `msgpack_serialize` wrote into `data` (bytes)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


# --- writing ---------------------------------------------------------------

def _pack_int(out, x):
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x + 0x100)
    elif x >= 0:
        for t, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                            (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if x <= top:
                out += bytes([t]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack")
    else:
        for t, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                            (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if x >= low:
                out += bytes([t]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_len(out, n, fix, fix_max, codes):
    """A header for `n` items or bytes: the fix form below `fix_max`, else
    the first of `codes` ((type byte, struct format, largest n)) that
    fits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for t, fmt, top in codes:
        if n <= top:
            out += bytes([t]) + struct.pack(fmt, n)
            return
    raise ValueError(f"{n} items or bytes do not fit msgpack")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))
_FIXEXT_CODE = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_header(out, code, n):
    """The header of an extension object of type `code` and `n` bytes."""
    if n in _FIXEXT_CODE:
        out.append(_FIXEXT_CODE[n])
    else:
        _pack_len(out, n, None, 0, _EXT)
    out += struct.pack(">b", code)


def _array_head(code, shape, dtype_name, raw):
    """Everything of an array leaf before its data: the extension header
    and flax's `_ndarray_to_bytes` prefix `(shape, dtype name, bin
    header)`."""
    prefix = bytearray()
    _pack_len(prefix, 3, 0x90, 16, _ARRAY)
    _pack_value(prefix, list(shape), ())
    _pack_value(prefix, dtype_name, ())
    _pack_len(prefix, raw.nbytes, None, 0, _BIN)
    out = bytearray()
    _ext_header(out, code, len(prefix) + raw.nbytes)
    return out + prefix


def _array_leaf(x, path):
    """(shape, dtype name, C-order bytes) of an ndarray or tensor leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).numpy()
            return tuple(x.shape), "bfloat16", _raw(bits)
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"leaf {'/'.join(map(str, path))!r}: object and "
                         "structured dtypes cannot be written")
    if x.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"leaf {'/'.join(map(str, path))!r} has {x.nbytes} "
                         f"bytes, more than MAX_CHUNK_SIZE ({MAX_CHUNK_SIZE}); "
                         "chunked leaves are not written")
    return x.shape, x.dtype.name, _raw(x)


def _raw(a):
    """The C-order bytes of array `a` as a memoryview (no copy when `a` is
    C-contiguous)."""
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _pack_value(out, x, path):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, _STR)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, _BIN)
        out += b
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, _MAP)
        for k in sorted(x):
            _pack_value(out, k, path)
            _pack_value(out, x[k], path + (k,))
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, _ARRAY)
        for i, v in enumerate(x):
            _pack_value(out, v, path + (i,))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        shape, name, raw = _array_leaf(x, path)
        out += _array_head(_EXT_NDARRAY, shape, name, raw)
        out += raw
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        raw = _raw(a)
        out += _array_head(_EXT_NPSCALAR, a.shape, a.dtype.name, raw)
        out += raw
    elif type(x) is complex:
        inner = bytearray()
        _pack_value(inner, [x.real, x.imag], path)
        _ext_header(out, _EXT_COMPLEX, len(inner))
        out += inner
    else:
        raise TypeError(f"leaf {'/'.join(map(str, path))!r} of type "
                        f"{type(x).__name__} cannot be written")


def _dump_value(f, x, path):
    if isinstance(x, dict):
        head = bytearray()
        _pack_len(head, len(x), 0x80, 16, _MAP)
        f.write(head)
        for k in sorted(x):
            key = bytearray()
            _pack_value(key, k, path)
            f.write(key)
            _dump_value(f, x[k], path + (k,))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        shape, name, raw = _array_leaf(x, path)
        f.write(_array_head(_EXT_NDARRAY, shape, name, raw))
        f.write(raw)
    else:
        out = bytearray()
        _pack_value(out, x, path)
        f.write(out)


def msgpack_dump(tree, f):
    """Write `tree` (see `msgpack_serialize`) to the binary file `f`, each
    array's data straight from its buffer (no copy of the whole tree in
    memory)."""
    _dump_value(f, tree, ())


def msgpack_serialize(tree):
    """`tree` (nested dicts of numpy arrays, numpy scalars, torch tensors and
    Python scalars) as bytes that flax's `msgpack_restore` reads."""
    buf = io.BytesIO()
    msgpack_dump(tree, buf)
    return buf.getvalue()
