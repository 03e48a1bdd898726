"""HDF5 files in numpy, struct and zlib: a reader for what libhdf5 writes
through h5py as Keras saves weights, and a writer for gzip'd dataset dumps.

    with File("specsegv3_chkpt.h5") as f:
        names = f["model_weights"].attrs["layer_names"]      # numpy S array
        kernel = f["model_weights/conv2d/conv2d/kernel:0"][()]

The reader takes:
  - superblocks of version 0 (h5py's default) and 2 or 3 (libver="latest");
  - object headers of version 1, with continuation blocks, and 2 (OHDR/OCHK);
  - old-style groups (symbol-table message: v1 B-tree of group nodes, local
    heap, SNOD nodes) and new-style compact groups (link messages, hard links);
  - attribute messages of versions 1 to 3 on every object: fixed-length byte
    strings, variable-length strings (from the global heap, GCOL), numbers,
    any shape, an empty shape (0,), a scalar; a null dataspace reads as None;
  - IEEE floats of 16, 32 and 64 bits and integers of 8 to 64 bits, in
    either byte order;
  - layout messages of versions 3 and 4: compact, contiguous (the undefined
    address of a dataset never written reads as its fill value), and chunked
    through a v1 B-tree, a single chunk, an implicit index or an unpaged
    fixed array, with the deflate, shuffle and fletcher32 filters.
Anything else (dense link or attribute storage in a fractal heap, soft and
external links, compound, enum, reference, array and opaque types, other
filters, virtual or external storage, the other chunk indexes) raises a
ValueError that names it: the reader never guesses. Checksums are not
verified.

Values read as h5py reads them: a dataset as an ndarray of its own dtype, an
attribute as an ndarray, or as a numpy scalar (a fixed string as np.bytes_)
for a scalar dataspace, a variable-length string as str (an object array of
str for an array of them). Group members iterate in name order, as h5py's.

The writer (`write_datasets`, `append_dataset`) writes superblock version 0
and a root symbol-table group of datasets, each chunked as h5py's
`guess_chunk` chunks it and deflated at level 9 (h5py's
compression="gzip", compression_opts=9), its dtype kept. Appending rewrites
the whole file, and refuses a file whose root holds anything but datasets
the reader reads (a group, an attribute): h5py would keep those.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enum", 10: "array", 11: "complex"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32015: "zstd"}
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
# IEEE layouts by size: (exponent location, exponent size, mantissa location,
# mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


def _refuse(what: str, where: str = "") -> ValueError:
    return ValueError(f"HDF5: {what} is not supported" + (f" ({where})" if where else ""))


class _VlenString:
    """The datatype of a variable-length string: each element is a
    (length, global heap collection, object index) triple."""

    def __init__(self, size: int, charset: int):
        self.itemsize, self.charset = size, charset


# -- the reader ----------------------------------------------------------------

class _Reader:
    """The file's bytes and its superblock's sizes; parses structures on
    demand."""

    def __init__(self, data: bytes, name: str):
        self.b, self.name = memoryview(data), name
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        base = 0
        while data[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base + 8 > len(data):
                raise ValueError(f"{name}: not an HDF5 file (no superblock signature)")
        self.base = base
        version = data[base + 8]
        if version in (0, 1):
            self.O, self.L = data[base + 13], data[base + 14]
            p = base + 24 + (4 if version == 1 else 0)
            addrs, p = self._addrs(p, 4)
            if addrs[0] != 0:
                raise _refuse(f"a base address of {addrs[0]}", name)
            # the root group's symbol table entry: name offset, object header
            self.root = self.addr(p + self.O)
        elif version in (2, 3):
            self.O, self.L = data[base + 9], data[base + 10]
            addrs, _ = self._addrs(base + 12, 4)
            if addrs[0] != 0:
                raise _refuse(f"a base address of {addrs[0]}", name)
            self.root = addrs[3] + base
        else:
            raise _refuse(f"superblock version {version}", name)
        self.undefined = (1 << (8 * self.O)) - 1
        if self.O not in (4, 8) or self.L not in (4, 8):
            raise _refuse(f"{self.O}-byte offsets and {self.L}-byte lengths", name)

    # primitive reads
    def uint(self, p: int, n: int) -> int:
        return int.from_bytes(self.b[p:p + n], "little")

    def addr(self, p: int) -> int:
        """The address at p, in file coordinates (None if undefined)."""
        v = self.uint(p, self.O)
        return None if v == (1 << (8 * self.O)) - 1 else v + self.base

    def length(self, p: int) -> int:
        return self.uint(p, self.L)

    def _addrs(self, p: int, n: int) -> Tuple[List[int], int]:
        out = [self.uint(p + i * self.O, self.O) for i in range(n)]
        return out, p + n * self.O

    def sig(self, p: int, want: bytes, what: str) -> None:
        if bytes(self.b[p:p + 4]) != want:
            raise ValueError(f"{self.name}: no {want.decode()} signature at {p} ({what})")

    # object headers
    def messages(self, addr: int) -> List[Tuple[int, int, memoryview]]:
        """(type, flags, body) of every message of the object header at
        addr, its continuation blocks followed."""
        b = self.b
        msgs = []
        if bytes(b[addr:addr + 4]) == b"OHDR":
            version, flags = b[addr + 4], b[addr + 5]
            if version != 2:
                raise _refuse(f"object header version {version}", self.name)
            p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            blocks = [(p + width, self.uint(p, width))]
            extra = 2 if flags & 0x04 else 0
            while blocks:
                p, size = blocks.pop(0)
                end = p + size
                while p + 4 + extra <= end:
                    mtype, msize, mflags = b[p], self.uint(p + 1, 2), b[p + 3]
                    body = b[p + 4 + extra:p + 4 + extra + msize]
                    p += 4 + extra + msize
                    if mtype == _CONTINUATION:
                        at, n = self._continuation(body)
                        self.sig(at, b"OCHK", "object header continuation")
                        blocks.append((at + 4, n - 8))
                    else:
                        msgs.append((mtype, mflags, body))
            return msgs
        version = b[addr]
        if version != 1:
            raise _refuse(f"object header version {version}", self.name)
        nmsgs, size = self.uint(addr + 2, 2), self.uint(addr + 8, 4)
        blocks = [(addr + 16, size)]
        while blocks and len(msgs) < nmsgs:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize, mflags = self.uint(p, 2), self.uint(p + 2, 2), b[p + 4]
                body = b[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append(self._continuation(body))
                msgs.append((mtype, mflags, body))
        return [m for m in msgs if m[0] != _CONTINUATION]

    def _continuation(self, body) -> Tuple[int, int]:
        return (int.from_bytes(body[:self.O], "little") + self.base,
                int.from_bytes(body[self.O:self.O + self.L], "little"))

    # the global heap
    def heap_object(self, collection: int, index: int) -> bytes:
        if collection not in self._heaps:
            self.sig(collection, b"GCOL", "global heap collection")
            size = self.length(collection + 8)
            p, end, objs = collection + 8 + self.L, collection + size, {}
            while p + 8 + self.L <= end:
                idx, n = self.uint(p, 2), self.length(p + 8)
                if idx == 0:
                    break                       # the free space, to the end
                objs[idx] = bytes(self.b[p + 8 + self.L:p + 8 + self.L + n])
                p += 8 + self.L + -(-n // 8) * 8
            self._heaps[collection] = objs
        return self._heaps[collection][index]


def _datatype(r: _Reader, body, p: int = 0):
    """(numpy dtype or _VlenString, bytes of the message) of the datatype at
    body[p:]."""
    cls, version = body[p] & 0x0F, body[p] >> 4
    bits = body[p + 1] | body[p + 2] << 8 | body[p + 3] << 16
    size = int.from_bytes(body[p + 4:p + 8], "little")
    order = ">" if bits & 1 else "<"
    if cls == 0:                                        # fixed-point
        offset, precision = struct.unpack_from("<HH", body, p + 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size or bits & 0x6:
            raise _refuse(f"a {precision}-bit integer at bit offset {offset} in {size} bytes",
                          r.name)
        kind = "i" if bits & 0x8 else "u"
        return np.dtype(f"{order}{kind}{size}"), 12
    if cls == 1:                                        # floating point
        offset, precision, eloc, esize, mloc, msize, bias = struct.unpack_from(
            "<HHBBBBI", body, p + 8)
        ieee = _IEEE.get(size)
        if bits & 0x40 or ieee is None or (eloc, esize, mloc, msize, bias) != ieee \
                or offset or precision != 8 * size or (bits >> 8) & 0xFF != 8 * size - 1 \
                or (bits >> 4) & 3 != 2:
            raise _refuse(f"a {size}-byte float that is not IEEE (bits {bits:#x}, "
                          f"exponent {eloc}/{esize}, mantissa {mloc}/{msize}, bias {bias})",
                          r.name)
        return np.dtype(f"{order}f{size}"), 20
    if cls == 3:                                        # fixed-length string
        return np.dtype(f"S{size}"), 8
    if cls == 9:                                        # variable length
        if bits & 0xF != 1:
            raise _refuse("a variable-length sequence", r.name)
        _, n = _datatype(r, body, p + 8)
        return _VlenString(size, (bits >> 8) & 0xF), 8 + n
    raise _refuse(f"the {_TYPE_CLASSES.get(cls, f'class-{cls}')} datatype (version {version})",
                  r.name)


def _dataspace(r: _Reader, body, p: int = 0) -> Optional[Tuple[int, ...]]:
    """The shape of the dataspace at body[p:]; None for a null dataspace."""
    version, rank = body[p], body[p + 1]
    if version == 1:
        start, kind = p + 8, 1
    elif version == 2:
        start, kind = p + 4, body[p + 3]
    else:
        raise _refuse(f"dataspace version {version}", r.name)
    if kind == 2:
        return None
    return tuple(int.from_bytes(body[start + i * r.L:start + (i + 1) * r.L], "little")
                 for i in range(rank))


def _decode(r: _Reader, raw, dtype, shape):
    """Elements of `dtype` in `raw` as h5py returns them."""
    count = int(np.prod(shape, dtype=np.int64))
    if isinstance(dtype, _VlenString):
        out = np.empty(count, object)
        step = 4 + r.O + 4
        for i in range(count):
            p = i * step
            n = int.from_bytes(raw[p:p + 4], "little")
            if n == 0:
                out[i] = ""
                continue
            at = int.from_bytes(raw[p + 4:p + 4 + r.O], "little") + r.base
            index = int.from_bytes(raw[p + 4 + r.O:p + 8 + r.O], "little")
            text = r.heap_object(at, index)[:n]
            out[i] = text.decode("utf-8" if dtype.charset == 1 else "ascii")
        return out.reshape(shape)
    return np.frombuffer(bytes(raw[:count * dtype.itemsize]), dtype, count).reshape(shape)


def _attribute(r: _Reader, body) -> Tuple[str, Any]:
    version, flags = body[0], body[1]
    name_n, type_n, space_n = struct.unpack_from("<HHH", body, 2)
    if flags & 0x3:
        raise _refuse("a shared datatype or dataspace in an attribute", r.name)
    if version == 1:
        pad = lambda n: -(-n // 8) * 8                  # noqa: E731
        p = 8
        name = bytes(body[p:p + name_n]).rstrip(b"\0").decode()
        p += pad(name_n)
        dtype, _ = _datatype(r, body, p)
        p += pad(type_n)
        shape = _dataspace(r, body, p)
        p += pad(space_n)
    elif version in (2, 3):
        p = 8 + (1 if version == 3 else 0)
        name = bytes(body[p:p + name_n]).rstrip(b"\0").decode()
        p += name_n
        dtype, _ = _datatype(r, body, p)
        p += type_n
        shape = _dataspace(r, body, p)
        p += space_n
    else:
        raise _refuse(f"attribute message version {version}", r.name)
    if shape is None:
        return name, None
    value = _decode(r, body[p:], dtype, shape)
    if shape == ():
        value = value[()]
    return name, value


def _attributes(r: _Reader, msgs, where: str) -> Dict[str, Any]:
    attrs = {}
    for mtype, _, body in msgs:
        if mtype == _ATTRIBUTE_INFO:
            p = 2 + (2 if body[1] & 1 else 0)
            if _addr(r, body, p) is not None:
                raise _refuse("dense attribute storage (fractal heap)", where)
        elif mtype == _ATTRIBUTE:
            name, value = _attribute(r, body)
            attrs[name] = value
    return attrs


class Dataset:
    """A dataset: `shape`, `dtype`, `attrs`; `ds[()]` or `np.asarray(ds)`
    reads it."""

    def __init__(self, r: _Reader, name: str, msgs):
        self._r, self.name = r, name
        self.attrs = _attributes(r, msgs, name)
        found = {t: body for t, flags, body in msgs
                 if t in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _FILL, _FILL_OLD)}
        for t, flags, _ in msgs:
            if flags & 0x02 and t in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                raise _refuse("a shared (committed) message", name)
            if t == _EXTERNAL:
                raise _refuse("external storage", name)
        shape = _dataspace(r, found[_DATASPACE])
        if shape is None:
            raise _refuse("a dataset of a null dataspace", name)
        self.shape = shape
        self.dtype, _ = _datatype(r, found[_DATATYPE])
        if isinstance(self.dtype, _VlenString):
            raise _refuse("a dataset of variable-length strings", name)
        self._filters = self._pipeline(found.get(_FILTERS))
        self._layout = found[_LAYOUT]
        self._fill = self._fill_value(found.get(_FILL), found.get(_FILL_OLD))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def _pipeline(self, body) -> List[Tuple[int, List[int]]]:
        if body is None:
            return []
        version, n = body[0], body[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = int.from_bytes(body[p:p + 2], "little")
            if version == 1 or fid >= 256:
                name_n = int.from_bytes(body[p + 2:p + 4], "little")
                p += 2
            else:
                name_n = 0
            nvals = int.from_bytes(body[p + 4:p + 6], "little")
            p += 6
            p += (-(-name_n // 8) * 8) if version == 1 else name_n
            vals = list(struct.unpack_from(f"<{nvals}I", body, p))
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                raise _refuse(f"the {_FILTER_NAMES.get(fid, f'id-{fid}')} filter", self.name)
            out.append((fid, vals))
        return out

    def _fill_value(self, new, old) -> Optional[bytes]:
        """The fill value's bytes, None for zeros."""
        if new is not None:
            version = new[0]
            if version in (1, 2):
                if new[3]:
                    n = int.from_bytes(new[4:8], "little")
                    return bytes(new[8:8 + n]) if n else None
                return None
            if version == 3:
                if new[1] & 0x20:
                    n = int.from_bytes(new[2:6], "little")
                    return bytes(new[6:6 + n]) if n else None
                return None
            raise _refuse(f"fill value message version {version}", self.name)
        if old is not None:
            n = int.from_bytes(old[0:4], "little")
            return bytes(old[4:4 + n]) if n else None
        return None

    def _empty(self) -> np.ndarray:
        out = np.zeros(self.shape, self.dtype)
        if self._fill is not None:
            out[...] = np.frombuffer(self._fill, self.dtype, 1)[0]
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        return self.read()[key]

    def read(self) -> np.ndarray:
        r, body = self._r, self._layout
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise _refuse(f"layout message version {version}", self.name)
        nbytes = self.size * self.dtype.itemsize
        if cls == 0:                                    # compact
            n = int.from_bytes(body[2:4], "little")
            return _decode(r, body[4:4 + n], self.dtype, self.shape).copy()
        if cls == 1:                                    # contiguous
            at = _addr(r, body, 2)
            if at is None or nbytes == 0:
                return self._empty()
            return _decode(r, r.b[at:at + nbytes], self.dtype, self.shape).copy()
        if cls == 2:
            return self._chunked(body, version)
        raise _refuse("virtual storage" if cls == 3 else f"layout class {cls}", self.name)

    def _chunked(self, body, version) -> np.ndarray:
        r = self._r
        if version == 3:
            ndims = body[2]
            index_addr = _addr(r, body, 3)
            p = 3 + r.O
            dims = struct.unpack_from(f"<{ndims}I", body, p)
            chunks = None if index_addr is None else self._btree_chunks(index_addr, ndims)
        else:
            flags, ndims, width = body[2], body[3], body[4]
            p = 5
            dims = tuple(int.from_bytes(body[p + i * width:p + (i + 1) * width], "little")
                         for i in range(ndims))
            p += ndims * width
            index, p = body[p], p + 1
            chunks = self._v4_chunks(body, p, index, flags, dims)
        chunk = tuple(dims[:-1])
        out = self._empty()
        if chunks is None or self.size == 0:
            return out
        itemsize = self.dtype.itemsize
        for offset, size, mask, at in chunks:
            raw = bytes(r.b[at:at + size])
            for i in reversed(range(len(self._filters))):
                if mask & (1 << i):
                    continue
                fid, vals = self._filters[i]
                if fid == _DEFLATE:
                    raw = zlib.decompress(raw)
                elif fid == _SHUFFLE:
                    raw = _unshuffle(raw, vals[0] if vals else itemsize)
                else:                                   # fletcher32: its checksum
                    raw = raw[:-4]
            block = np.frombuffer(raw, self.dtype, int(np.prod(chunk))).reshape(chunk)
            sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self.shape))
            out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
        return out

    def _btree_chunks(self, addr: int, ndims: int):
        """(offset, size, filter mask, address) of every chunk under the v1
        B-tree node at addr."""
        r, out = self._r, []
        key_n = 8 + 8 * ndims
        stack = [addr]
        while stack:
            at = stack.pop()
            r.sig(at, b"TREE", "chunk B-tree")
            if r.b[at + 4] != 1:
                raise ValueError(f"{self.name}: a group B-tree node in a chunk index")
            level, used = r.b[at + 5], r.uint(at + 6, 2)
            p = at + 8 + 2 * r.O
            for _ in range(used):
                size, mask = r.uint(p, 4), r.uint(p + 4, 4)
                offset = tuple(r.uint(p + 8 + 8 * i, 8) for i in range(ndims - 1))
                child = r.addr(p + key_n)
                if level:
                    stack.append(child)
                else:
                    out.append((offset, size, mask, child))
                p += key_n + r.O
        return out

    def _v4_chunks(self, body, p, index, flags, dims):
        r = self._r
        chunk = dims[:-1]
        csize = int(np.prod(chunk)) * self.dtype.itemsize
        grid = [-(-s // c) for s, c in zip(self.shape, chunk)]

        def offset(i):
            return tuple(int(k) * c for k, c in zip(np.unravel_index(i, grid), chunk))

        if index == 1:                                  # single chunk
            size, mask = csize, 0
            if flags & 0x2:
                size = _length(r, body, p)
                mask = int.from_bytes(body[p + r.L:p + r.L + 4], "little")
                p += r.L + 4
            at = _addr(r, body, p)
            return None if at is None else [((0,) * len(chunk), size, mask, at)]
        if index == 2:                                  # implicit: chunks in order
            at = _addr(r, body, p)
            if at is None:
                return None
            return [(offset(i), csize, 0, at + i * csize) for i in range(int(np.prod(grid)))]
        if index == 3:                                  # fixed array
            at = _addr(r, body, p + 1)
            return None if at is None else self._fixed_array(at, offset, csize)
        names = {4: "extensible array", 5: "version 2 B-tree"}
        raise _refuse(f"the {names.get(index, f'type-{index}')} chunk index", self.name)

    def _fixed_array(self, header, offset, csize):
        r = self._r
        r.sig(header, b"FAHD", "fixed array header")
        client, entry_n, page_bits = r.b[header + 5], r.b[header + 6], r.b[header + 7]
        n = r.length(header + 8)
        block = r.addr(header + 8 + r.L)
        if n > (1 << page_bits):
            raise _refuse("a paged fixed array chunk index", self.name)
        r.sig(block, b"FADB", "fixed array data block")
        p, out = block + 6 + r.O, []
        for i in range(n):
            at = r.addr(p)
            if client == 1:
                size_n = entry_n - r.O - 4
                size, mask = r.uint(p + r.O, size_n), r.uint(p + r.O + size_n, 4)
            else:
                size, mask = csize, 0
            if at is not None:
                out.append((offset(i), size, mask, at))
            p += entry_n
        return out


def _addr(r: _Reader, body, p: int) -> Optional[int]:
    v = int.from_bytes(body[p:p + r.O], "little")
    return None if v == r.undefined else v + r.base


def _length(r: _Reader, body, p: int) -> int:
    return int.from_bytes(body[p:p + r.L], "little")


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    n = len(raw) // itemsize
    if itemsize <= 1 or n == 0:
        return raw
    head = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n).T
    return head.tobytes() + raw[n * itemsize:]


class Group:
    """A group: `attrs`, its members by name (`g["a/b"]`, `"a" in g`,
    iteration and `keys()` in name order) and `visititems`."""

    def __init__(self, r: _Reader, name: str, msgs):
        self._r, self.name = r, name
        self.attrs = _attributes(r, msgs, name)
        self._links: Dict[str, Any] = {}
        for mtype, _, body in msgs:
            if mtype == _SYMBOL_TABLE:
                self._symbol_table(_addr(r, body, 0), _addr(r, body, r.O))
            elif mtype == _LINK_INFO:
                p = 2 + (8 if body[1] & 1 else 0)
                if _addr(r, body, p) is not None:
                    raise _refuse("dense link storage (fractal heap)", name)
            elif mtype == _LINK:
                self._link(body)

    def _symbol_table(self, btree: int, heap: int) -> None:
        r = self._r
        r.sig(heap, b"HEAP", "local heap")
        data = r.addr(heap + 8 + 2 * r.L)
        stack = [btree]
        while stack:
            at = stack.pop()
            r.sig(at, b"TREE", "group B-tree")
            level, used = r.b[at + 5], r.uint(at + 6, 2)
            p = at + 8 + 2 * r.O + r.L
            for _ in range(used):
                child = r.addr(p)
                p += r.O + r.L
                if level:
                    stack.append(child)
                    continue
                r.sig(child, b"SNOD", "symbol table node")
                q = child + 8
                for _ in range(r.uint(child + 6, 2)):
                    name_at = data + r.length(q)
                    end = bytes(r.b[name_at:name_at + 65536]).index(b"\0")
                    name = bytes(r.b[name_at:name_at + end]).decode()
                    self._links[name] = r.addr(q + r.O)
                    q += 2 * r.O + 24

    def _link(self, body) -> None:
        r = self._r
        flags, p = body[1], 2
        kind = 0
        if flags & 0x08:
            kind, p = body[p], p + 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(body[p:p + width], "little")
        p += width
        name = bytes(body[p:p + n]).decode()
        p += n
        if kind == 0:
            self._links[name] = _addr(r, body, p)
        else:
            self._links[name] = ValueError(
                f"HDF5: {'a soft' if kind == 1 else 'an external'} link is not supported "
                f"({self.name}/{name})")

    def keys(self) -> List[str]:
        return sorted(self._links, key=lambda k: k.encode())

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, path: str) -> bool:
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node._links:
                return False
            node = node._child(part)
        return True

    def _child(self, name: str):
        at = self._links[name]
        if isinstance(at, Exception):
            raise at
        path = f"{self.name.rstrip('/')}/{name}"
        msgs = self._r.messages(at)
        types = {m[0] for m in msgs}
        if _LAYOUT in types:
            return Dataset(self._r, path, msgs)
        if types & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
            return Group(self._r, path, msgs)
        if _DATATYPE in types:
            raise _refuse("a committed datatype", path)
        raise _refuse("an object that is neither a group nor a dataset", path)

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is a dataset, not a group ({path})")
            if part not in node._links:
                raise KeyError(f"{path!r} not found in {self.name}")
            node = node._child(part)
        return node

    def visititems(self, fn: Callable[[str, Any], Any]):
        """fn(relative path, object) for every object below, depth first in
        name order, as h5py's visititems; stops at the first non-None."""
        def walk(group: Group, prefix: str):
            for key in group.keys():
                obj = group[key]
                path = f"{prefix}{key}"
                ret = fn(path, obj)
                if ret is not None:
                    return ret
                if isinstance(obj, Group):
                    ret = walk(obj, path + "/")
                    if ret is not None:
                        return ret
            return None
        return walk(self, "")


class File(Group):
    """An HDF5 file read whole into memory: the root group."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        r = _Reader(data, os.fspath(path))
        super().__init__(r, "/", r.messages(r.root))
        self.filename = os.fspath(path)

    def close(self) -> None:
        """Nothing is held open."""

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the writer ----------------------------------------------------------------

# h5py's guess_chunk (h5py/_hl/filters.py): halve the axes in turn until a
# chunk is near a size that grows with the dataset's
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024
GZIP_LEVEL = 9
_O = _L = 8                        # offsets and lengths of 8 bytes
_UNDEF = b"\xff" * 8
# B-tree and symbol-table node capacities libhdf5 assumes by default: a group
# leaf holds 2 x 4 symbols, a group node 2 x 16 children, a chunk node 2 x 32
_GROUP_LEAF_K, _GROUP_NODE_K, _CHUNK_NODE_K = 4, 16, 32
_FREE_NULL = 1                     # a local heap's "no free block"


def guess_chunk(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """The chunk shape h5py gives a dataset of `shape` whose elements take
    `itemsize` bytes."""
    if not shape:
        raise ValueError("HDF5: a scalar dataset cannot be chunked")
    chunks = np.array([x if x else 1024 for x in shape], dtype=np.float64)
    target = CHUNK_BASE * 2 ** math.log10(float(np.prod(chunks)) * itemsize / 2 ** 20)
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    i = 0
    while True:
        nbytes = float(np.prod(chunks)) * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and nbytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[i % len(chunks)] = math.ceil(chunks[i % len(chunks)] / 2.0)
        i += 1
    return tuple(int(x) for x in chunks)


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                            not np.little_endian) else 0
    size = dtype.itemsize
    if dtype.kind == "f" and size in _IEEE:
        eloc, esize, mloc, msize, bias = _IEEE[size]
        bits = order | 0x20 | ((8 * size - 1) << 8)     # mantissa normalised: implied
        return (bytes([0x11, bits & 0xFF, bits >> 8, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, mloc, msize, bias)
                + b"\0" * 4)
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size) + b"\0" * 4)
    raise ValueError(f"HDF5 writer: dtype {dtype} is not supported (IEEE floats and "
                     "integers only)")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Out:
    """A growing file image; `reserve` hands out addresses."""

    def __init__(self):
        self.parts: List[bytes] = []
        self.size = 0

    def put(self, data: bytes) -> int:
        at = self.size
        self.parts.append(data)
        self.size += len(data)
        return at

    def reserve(self, n: int) -> int:
        return self.put(b"\0" * n)

    def patch(self, at: int, data: bytes) -> None:
        """Overwrite reserved bytes (joins the parts once)."""
        whole = bytearray(b"".join(self.parts))
        whole[at:at + len(data)] = data
        self.parts = [bytes(whole)]


def _btree_node(node_type: int, level: int, keys: List[bytes], children: List[int],
                k: int, key_n: int) -> bytes:
    out = b"TREE" + bytes([node_type, level]) + struct.pack("<H", len(children))
    out += _UNDEF + _UNDEF
    for key, child in zip(keys, children):
        out += key + struct.pack("<Q", child)
    out += keys[len(children)]
    return out + b"\0" * (24 + (2 * k + 1) * key_n + 2 * k * _O - len(out))


def _btree(out: _Out, node_type: int, leaves: List[Tuple[bytes, bytes, int]], k: int,
           key_n: int) -> int:
    """Write a v1 B-tree over `leaves` ((left key, right key, address), in
    order) and return its root's address. A chunk node's key i is child i's
    left key; a group node's key i (i > 0) is child i - 1's right key (its
    last name); both end on the last child's right key."""
    level = 0
    while True:
        nodes = []
        for i in range(0, max(len(leaves), 1), 2 * k):
            group = leaves[i:i + 2 * k]
            if node_type == 1:
                keys = [g[0] for g in group] + [group[-1][1]]
            else:
                keys = [group[0][0]] + [g[1] for g in group]
            at = out.put(_btree_node(node_type, level, keys, [g[2] for g in group], k, key_n))
            nodes.append((group[0][0], group[-1][1], at))
        if len(nodes) == 1:
            return nodes[0][2]
        leaves, level = nodes, level + 1


def _dataset(out: _Out, array: np.ndarray) -> int:
    """Write `array` as a chunked, deflated dataset; its object header's
    address."""
    shape, itemsize = array.shape, array.dtype.itemsize
    chunk = guess_chunk(shape, itemsize)
    ndims = len(shape) + 1
    key_n = 8 + 8 * ndims
    leaves = []
    grid = [-(-s // c) for s, c in zip(shape, chunk)]
    for index in np.ndindex(*grid) if array.size else ():
        offset = [i * c for i, c in zip(index, chunk)]
        block = np.zeros(chunk, array.dtype)
        sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape))
        block[tuple(slice(0, x.stop - x.start) for x in sl)] = array[sl]
        data = zlib.compress(block.tobytes(), GZIP_LEVEL)
        left = struct.pack("<II", len(data), 0) + struct.pack(f"<{ndims}Q", *offset, 0)
        right = struct.pack("<II", 0, 0) + struct.pack(
            f"<{ndims}Q", *[o + c for o, c in zip(offset, chunk)], itemsize)
        leaves.append((left, right, out.put(data)))
    index_at = _btree(out, 1, leaves, _CHUNK_NODE_K, key_n) if leaves else None
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    space = struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims
    fill = bytes([2, 3, 2, 1]) + struct.pack("<I", 0)
    pipeline = (struct.pack("<BB6x", 1, 1) + struct.pack("<HHHH", _DEFLATE, 8, 1, 1)
                + b"deflate\0" + struct.pack("<II", GZIP_LEVEL, 0))
    layout = (bytes([3, 2, ndims]) + (_UNDEF if index_at is None else struct.pack("<Q", index_at))
              + struct.pack(f"<{ndims}I", *chunk, itemsize))
    return out.put(_object_header([
        _message(_DATASPACE, space), _message(_DATATYPE, _datatype_message(array.dtype), 1),
        _message(_FILL, fill, 1), _message(_FILTERS, pipeline, 1),
        _message(_LAYOUT, layout)]))


def write_datasets(path: str, datasets: Mapping[str, np.ndarray]) -> int:
    """Write a new file at `path` (through a temporary file, renamed into
    place) whose root group holds `datasets`, each chunked and deflated at
    level 9; returns the file's size."""
    names = sorted(datasets, key=lambda n: n.encode())
    for name in names:
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"HDF5 writer: {name!r} is not a dataset name of the root group")
        if np.ndim(datasets[name]) == 0:
            raise ValueError(f"HDF5 writer: {name!r} is a scalar; a scalar dataset cannot be "
                             "chunked or compressed (as h5py refuses it)")
    out = _Out()
    superblock = out.reserve(96)
    root_header = out.reserve(16 + 24)
    heap_data = b"\0" * 8
    offsets = {}
    for name in names:
        offsets[name] = len(heap_data)
        raw = name.encode() + b"\0"
        heap_data += raw + b"\0" * (-len(raw) % 8)
    heap = out.put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), _FREE_NULL,
                                                    out.size + 32))
    out.put(heap_data)
    headers = {name: _dataset(out, np.asarray(datasets[name])) for name in names}
    leaves = []
    per_node = 2 * _GROUP_LEAF_K
    for i in range(0, len(names), per_node):
        group = names[i:i + per_node]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(group))
        for name in group:
            node += struct.pack("<QQII16x", offsets[name], headers[name], 0, 0)
        node += b"\0" * (8 + per_node * 40 - len(node))
        left = struct.pack("<Q", 0 if i == 0 else offsets[names[i - 1]])
        leaves.append((left, struct.pack("<Q", offsets[group[-1]]), out.put(node)))
    if not leaves:                 # an empty root: a leaf node of no symbols
        leaves = [(bytes(8), bytes(8), out.put(b"SNOD" + struct.pack("<BBH", 1, 0, 0)
                                               + bytes(per_node * 40)))]
    btree = _btree(out, 0, leaves, _GROUP_NODE_K, _L)
    out.patch(root_header, _object_header([
        _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
    out.patch(superblock, SIGNATURE + bytes([0, 0, 0, 0, 0, _O, _L, 0])
              + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
              + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", out.size) + _UNDEF
              + struct.pack("<QQII", 0, root_header, 1, 0) + struct.pack("<QQ", btree, heap))
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        for part in out.parts:
            f.write(part)
    os.replace(tmp, path)
    return out.size


def read_datasets(path: str) -> Dict[str, np.ndarray]:
    """Every dataset of a file whose root holds datasets only, by name;
    anything else in the root (a group, an attribute on the root or on a
    dataset) raises, naming it."""
    f = File(path)
    if f.attrs:
        raise ValueError(f"{path}: the root group has attributes {sorted(f.attrs)}; the "
                         "HDF5 writer keeps datasets only")
    out = {}
    for name in f.keys():
        obj = f[name]
        if not isinstance(obj, Dataset):
            raise ValueError(f"{path}: the root holds the group {name!r}; the HDF5 writer "
                             "keeps datasets only")
        if obj.attrs:
            raise ValueError(f"{path}: the dataset {name!r} has attributes "
                             f"{sorted(obj.attrs)}; the HDF5 writer keeps datasets only")
        out[name] = obj.read()
    return out


def append_dataset(path: str, name: str, array: Any) -> int:
    """Add the dataset `name` to the file at `path` (made if absent) by
    rewriting it with every dataset it held; returns the file's size. A name
    already there raises, as h5py's create_dataset does."""
    held = read_datasets(path) if os.path.exists(path) else {}
    if name in held:
        raise ValueError(f"{path}: unable to create dataset {name!r} (name already exists)")
    held[name] = np.asarray(array)
    return write_datasets(path, held)
