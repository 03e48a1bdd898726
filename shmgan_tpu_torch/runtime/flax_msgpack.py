"""The subset of msgpack that `flax.serialization` writes, in the standard
library and numpy: `dumps(tree)` gives the bytes `flax.serialization.to_bytes`
gives for the same tree of dicts, and `loads(data)` reads them back as
`flax.serialization.msgpack_restore` does.

Supported: maps (keys in the tree's insertion order), strings, bins,
arrays, ints, floats, nil, bools, and two ext types:
  1  ndarray: the payload is the msgpack array [shape, dtype name,
     C-order bytes]; numpy arrays are written little-endian;
  3  numpy scalar: an ndarray payload of shape ().
An array larger than MAX_CHUNK_SIZE bytes is written, as flax writes it, as
the map {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat chunk, ...}} and read back as one array.

A "bfloat16" ndarray (which numpy cannot hold) is read as float32, widened
exactly, and written from a `BFloat16Array` (its 16-bit patterns); the writer
takes numpy dtypes otherwise.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: arrays above this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30


# -- writer -------------------------------------------------------------------

class BFloat16Array:
    """A bfloat16 array for `dumps`: its bit patterns as a uint16 array,
    written as flax writes an ml_dtypes bfloat16 ndarray."""

    def __init__(self, bits: np.ndarray):
        if bits.dtype != np.uint16:
            raise ValueError(f"bfloat16 bits must be uint16, got {bits.dtype}")
        self.bits = bits


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    """A length-prefixed header: a fix form up to fix_max, else the
    smallest of the 8-, 16- and 32-bit forms `codes` allows."""
    if fix is not None and n <= fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: object of length {n} is too large")


def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(bytes((x,)))
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2 ** 64 - 1)):
            if x <= top:
                out.append(struct.pack(fmt, code, x))
                return
        raise ValueError(f"msgpack: integer {x} is too large")
    elif x >= -32:
        out.append(struct.pack(">b", x))
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2 ** 7), (0xD1, ">Bh", -2 ** 15),
                               (0xD2, ">Bi", -2 ** 31), (0xD3, ">Bq", -2 ** 63)):
            if x >= low:
                out.append(struct.pack(fmt, code, x))
                return
        raise ValueError(f"msgpack: integer {x} is too small")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: cannot serialise an array of dtype {arr.dtype}")
    arr = np.asarray(arr, arr.dtype.newbyteorder("<"))
    return dumps([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(bytes((fixed[len(data)],)))
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(data)


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: List[bytes], obj: Any) -> None:
    if isinstance(obj, BFloat16Array):
        bits = np.ascontiguousarray(obj.bits, "<u2")
        if bits.nbytes > MAX_CHUNK_SIZE:
            raise ValueError("msgpack: a bfloat16 array above MAX_CHUNK_SIZE bytes")
        _pack_ext(out, EXT_NDARRAY, dumps([list(bits.shape), "bfloat16", bits.tobytes("C")]))
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(obj))
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot serialise {type(obj).__name__}")


def dumps(tree: Any) -> bytes:
    """msgpack bytes of a tree of dicts whose leaves are numpy arrays and
    scalars, Python scalars, strings or bytes."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# -- reader -------------------------------------------------------------------

# type bytes: nil and the bools; numbers (struct format); the length prefix
# of bin (C4-C6), ext (C7-C9), str (D9-DB), array (DC-DD) and map (DE-DF)
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: data ends inside an object (truncated file?)")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b not in _LENGTHS:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        n = self.unpack(_LENGTHS[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        inner = _Reader(data)
        shape, name, raw = inner.obj()
        if inner.pos != len(data):
            raise ValueError("msgpack: trailing bytes in an ndarray payload")
        if name == "bfloat16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            arr = np.frombuffer(raw, np.dtype(name).newbyteorder("<")).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """The tree of `data`: dicts, lists and Python scalars, ndarrays (read
    only, viewing `data`) and numpy scalars; chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return _unchunk(tree)
