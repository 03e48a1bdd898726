"""Zstandard decompression (RFC 8878) in the standard library, for TIFF's
Zstd compression (50000), which PIL reads through libtiff and libzstd.

    raw = zstd_decompress(data, need)   # bytes: the first `need` bytes of the frames

Read: frames (and skippable frames) without a dictionary; raw, RLE and
compressed blocks; literals raw, RLE, Huffman-coded in one or four streams
(weights direct or FSE-compressed) and treeless (the previous block's
table); sequences with predefined, RLE, FSE-compressed and repeated tables,
and the three repeat offsets. The content checksum is skipped. Entropy
decoding is a per-symbol loop over plain lists and integers: FSE states,
Huffman lookahead tables, and each stream as one integer read backward
from its end marker. Decoding stops once `need` bytes are out, as libtiff's
codec stops at the end of its strip buffer, and a block (or its literals)
larger than Block_Maximum_Size, min(Window_Size, 128 KiB), is corrupt: a
few bytes of input never write more than `need` plus one block. Corrupt or
truncated data raises ValueError.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

_MAGIC = 0xFD2FB528
_BLOCK_MAX = 1 << 17
# RFC 8878 3.1.1.3.2.2: predefined distributions and accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_MAX_LOG = {"ll": 9, "ml": 9, "of": 8}
_MAX_SYMBOL = {"ll": 35, "ml": 52, "of": 31}
# literal and match length codes -> (baseline, extra bits)
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]


def _corrupt(what: str) -> ValueError:
    return ValueError(f"TIFF: corrupt Zstd data ({what})")


class _Back:
    """A bitstream read backward (RFC 8878 4.1): its bytes as one integer,
    read from just below the highest set bit of the last byte; bits past
    the start read as zeros (`pos` then goes negative)."""
    __slots__ = ("x", "pos")

    def __init__(self, data: bytes):
        if not data or not data[-1]:
            raise _corrupt("a bitstream without its end marker")
        self.x = int.from_bytes(data, "little")
        self.pos = self.x.bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        if self.pos >= 0:
            return (self.x >> self.pos) & ((1 << n) - 1)
        return (self.x << -self.pos) & ((1 << n) - 1)


class _Forward:
    """A little-endian forward bitstream (FSE table descriptions)."""
    __slots__ = ("x", "pos", "n")

    def __init__(self, data: bytes):
        self.x, self.pos, self.n = int.from_bytes(data, "little"), 0, 8 * len(data)

    def peek(self, n: int) -> int:
        return (self.x >> self.pos) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.n:
            raise _corrupt("a table description cut short")


def _read_fse_table(data: bytes, max_log: int, max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description (FSE_readNCount): (normalized counts,
    accuracy log, bytes used)."""
    bits = _Forward(data)
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        raise _corrupt(f"accuracy log {log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    probs: List[int] = []
    previous0 = False
    while remaining > 1 and len(probs) <= max_symbol:
        if previous0:
            while True:
                repeat = bits.peek(2)
                bits.skip(2)
                probs += [0] * repeat
                if repeat != 3:
                    break
            if len(probs) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < top:
            count = low
            bits.skip(nbits - 1)
        else:
            count = bits.peek(nbits)
            if count >= threshold:
                count -= top
            bits.skip(nbits)
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(probs) > max_symbol + 1:
        raise _corrupt("a table description whose counts do not sum")
    return probs, log, (bits.pos + 7) // 8


def _fse_decoding_table(probs: List[int], log: int) -> List[Tuple[int, int, int]]:
    """FSE_buildDTable: state -> (symbol, bits to read, base of the next state)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(p)
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _corrupt("an FSE table that does not fill")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


def _huffman_weights(block: bytes, at: int) -> Tuple[List[int], int]:
    """A Huffman tree description -> (weights of symbols 0.., bytes used)."""
    header = block[at]
    if header >= 128:
        n = header - 127
        raw = block[at + 1:at + 1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _corrupt("Huffman weights cut short")
        weights = [v for b in raw for v in (b >> 4, b & 15)][:n]
        return weights, 1 + (n + 1) // 2
    data = block[at + 1:at + 1 + header]
    if len(data) < header:
        raise _corrupt("Huffman weights cut short")
    probs, log, used = _read_fse_table(data, 6, 255)
    table = _fse_decoding_table(probs, log)
    stream = _Back(data[used:])
    states = [stream.read(log), stream.read(log)]
    weights: List[int] = []
    turn = 0
    # two states take turns over one stream until a state update reads past
    # its start; then the other state gives the last weight
    while len(weights) < 255:
        sym, nb, base = table[states[turn]]
        weights.append(sym)
        states[turn] = base + stream.read(nb)
        if stream.pos < 0:
            weights.append(table[states[1 - turn]][0])
            return weights, 1 + header
        turn = 1 - turn
    raise _corrupt("too many Huffman weights")


def _huffman_table(weights: List[int]) -> Tuple[List[Tuple[int, int]], int]:
    """Weights (the last one implied) -> the decoding table of 2 ** max_bits
    entries (symbol, code length) and max_bits (HUF_readDTableX1)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if not total or any(w > 11 for w in weights):
        raise _corrupt("Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise _corrupt("Huffman weights that do not complete a tree")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise _corrupt("a Huffman code over 11 bits")
    table: List[Tuple[int, int]] = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return table, max_bits


def _huffman_stream(data: bytes, table, max_bits: int, count: int, out: bytearray) -> None:
    stream = _Back(data)
    for _ in range(count):
        sym, nb = table[stream.read(max_bits)]
        stream.pos += max_bits - nb
        out.append(sym)
    if stream.pos != 0:
        raise _corrupt("a Huffman stream of the wrong length")


class _Frame:
    """The state one frame carries from block to block."""

    def __init__(self):
        self.huffman: Optional[Tuple[list, int]] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(block: bytes, frame: _Frame, block_max: int) -> Tuple[bytearray, int]:
    """The literals section -> (literals, bytes used)."""
    kind, size_format = block[0] & 3, (block[0] >> 2) & 3
    if kind in (0, 1):
        if size_format in (0, 2):
            size, at = block[0] >> 3, 1
        elif size_format == 1:
            size, at = (block[0] >> 4) + (block[1] << 4), 2
        else:
            size, at = (block[0] >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if size > block_max:
            raise _corrupt(f"{size} literals in a block of at most {block_max} bytes")
        if kind == 0:
            if at + size > len(block):
                raise _corrupt("raw literals cut short")
            return bytearray(block[at:at + size]), at + size
        return bytearray(block[at:at + 1] * size), at + 1
    nbytes = {0: 3, 1: 3, 2: 4, 3: 5}[size_format]
    v = int.from_bytes(block[:nbytes], "little")
    width = {3: 10, 4: 14, 5: 18}[nbytes]
    size = (v >> 4) & ((1 << width) - 1)
    csize = (v >> (4 + width)) & ((1 << width) - 1)
    if size > block_max:
        raise _corrupt(f"{size} literals in a block of at most {block_max} bytes")
    streams = 1 if size_format == 0 else 4
    at = nbytes
    if at + csize > len(block):
        raise _corrupt("Huffman literals cut short")
    end = at + csize
    if kind == 2:
        weights, used = _huffman_weights(block, at)
        frame.huffman = _huffman_table(weights)
        at += used
    elif frame.huffman is None:
        raise _corrupt("treeless literals without a previous table")
    table, max_bits = frame.huffman
    out = bytearray()
    if streams == 1:
        _huffman_stream(block[at:end], table, max_bits, size, out)
        return out, end
    sizes = [int.from_bytes(block[at + 2 * i:at + 2 * i + 2], "little") for i in range(3)]
    at += 6
    sizes.append(end - at - sum(sizes))
    if sizes[3] < 0:
        raise _corrupt("a jump table past its literals")
    each = (size + 3) // 4
    for i, n in enumerate(sizes):
        _huffman_stream(block[at:at + n], table, max_bits, each if i < 3 else size - 3 * each,
                        out)
        at += n
    return out, end


def _sequence_table(block: bytes, at: int, mode: int, kind: str, frame: _Frame):
    """One of the three sequence tables, by its mode -> (table, log, bytes used)."""
    if mode == 0:
        probs, log = {"ll": _LL_DEFAULT, "ml": _ML_DEFAULT, "of": _OF_DEFAULT}[kind]
        got = (_fse_decoding_table(probs, log), log)
        used = 0
    elif mode == 1:
        if at >= len(block):
            raise _corrupt("an RLE table cut short")
        got, used = ([(block[at], 0, 0)], 0), 1
    elif mode == 2:
        probs, log, used = _read_fse_table(block[at:at + 512], _MAX_LOG[kind], _MAX_SYMBOL[kind])
        got = (_fse_decoding_table(probs, log), log)
    else:
        if frame.tables[kind] is None:
            raise _corrupt("a repeated table without a previous one")
        got, used = frame.tables[kind], 0
    frame.tables[kind] = got
    return got, used


def _block(block: bytes, frame: _Frame, out: bytearray, block_max: int, need: int) -> None:
    """A compressed block onto `out` (the frame's output so far), stopping
    once `out` holds `need` bytes."""
    cap = len(out) + block_max
    literals, at = _literals(block, frame, block_max)
    if at >= len(block):
        raise _corrupt("a block without its sequences section")
    b0 = block[at]
    if b0 == 0:
        n, at = 0, at + 1
    elif b0 < 128:
        n, at = b0, at + 1
    elif b0 < 255:
        n, at = ((b0 - 128) << 8) + block[at + 1], at + 2
    else:
        n, at = block[at + 1] + (block[at + 2] << 8) + 0x7F00, at + 3
    if n == 0:
        out += literals
        return
    modes = block[at]
    at += 1
    if modes & 3:
        raise _corrupt("reserved bits of the table modes")
    tabs = {}
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        tabs[kind], used = _sequence_table(block, at, (modes >> shift) & 3, kind, frame)
        at += used
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = tabs["ll"], tabs["of"], tabs["ml"]
    stream = _Back(block[at:])
    ll_s, of_s, ml_s = stream.read(ll_log), stream.read(of_log), stream.read(ml_log)
    reps = frame.reps
    lit = 0
    for i in range(n):
        of_code, ml_code, ll_code = of_t[of_s][0], ml_t[ml_s][0], ll_t[ll_s][0]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise _corrupt("a sequence code out of range")
        value = (1 << of_code) + stream.read(of_code)
        base, nb = _ML_CODES[ml_code]
        ml = base + stream.read(nb)
        base, nb = _LL_CODES[ll_code]
        ll = base + stream.read(nb)
        if value > 3:
            offset = value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = value + (ll == 0)
            if idx == 1:
                offset = reps[0]
            elif idx == 2:
                offset = reps[1]
                reps[:] = [offset, reps[0], reps[2]]
            elif idx == 3:
                offset = reps[2]
                reps[:] = [offset, reps[0], reps[1]]
            else:
                offset = reps[0] - 1
                reps[:] = [offset, reps[0], reps[1]]
        if i < n - 1:
            sym, nb, nxt = ll_t[ll_s]
            ll_s = nxt + stream.read(nb)
            sym, nb, nxt = ml_t[ml_s]
            ml_s = nxt + stream.read(nb)
            sym, nb, nxt = of_t[of_s]
            of_s = nxt + stream.read(nb)
        if lit + ll > len(literals):
            raise _corrupt("a sequence past its literals")
        if len(out) + ll + ml > cap:
            raise _corrupt(f"a block of more than {block_max} bytes")
        if len(out) >= need:
            return
        out += literals[lit:lit + ll]
        lit += ll
        if offset <= 0 or offset > len(out):
            raise _corrupt("a match before the start of the data")
        if len(out) >= need:
            return
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:                                   # an overlapping copy repeats its period
            out += (out[start:] * (ml // offset + 1))[:ml]
    if stream.pos != 0:
        raise _corrupt("a sequences bitstream of the wrong length")
    out += literals[lit:]


def zstd_decompress(data: bytes, need: int) -> bytes:
    """Zstandard frames -> their first `need` bytes (all of them if fewer)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    while pos + 4 <= len(data) and len(out) < need:
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if 0x184D2A50 <= magic <= 0x184D2A5F:              # a skippable frame
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        if magic != _MAGIC:
            raise _corrupt("no frame magic number")
        if pos + 5 > len(data):
            raise _corrupt("a frame header cut short")
        fhd = data[pos + 4]
        single = (fhd >> 5) & 1
        if fhd & 8:
            raise _corrupt("a reserved frame header bit")
        did_size = (0, 1, 2, 4)[fhd & 3]
        fcs_size = (single, 2, 4, 8)[fhd >> 6]
        at = pos + 5 + (0 if single else 1)
        if did_size and any(data[at:at + did_size]):
            raise ValueError("TIFF: a Zstd frame that needs a dictionary is not decoded by the "
                             "port")
        at += did_size + fcs_size
        if at > len(data):
            raise _corrupt("a frame header cut short")
        if single:                             # the window is the frame content size
            window = int.from_bytes(data[at - fcs_size:at], "little") + (256 if fcs_size == 2
                                                                           else 0)
        else:                                  # RFC 8878 3.1.1.1.2, the window descriptor
            wd = data[pos + 5]
            base = 1 << (10 + (wd >> 3))
            window = base + (base >> 3) * (wd & 7)
        block_max = min(window, _BLOCK_MAX)
        frame = _Frame()
        while len(out) < need:
            if at + 3 > len(data):
                raise _corrupt("a block header cut short")
            header = int.from_bytes(data[at:at + 3], "little")
            last, kind, size = header & 1, (header >> 1) & 3, header >> 3
            at += 3
            if size > block_max:
                raise _corrupt(f"a block of {size} bytes, past its maximum of {block_max}")
            if kind == 1:
                if at >= len(data):
                    raise _corrupt("an RLE block cut short")
                out += data[at:at + 1] * size
                at += 1
            else:
                if at + size > len(data):
                    raise _corrupt("a block cut short")
                if kind == 0:
                    out += data[at:at + size]
                elif kind == 2:
                    _block(data[at:at + size], frame, out, block_max, need)
                else:
                    raise _corrupt("a reserved block type")
                at += size
            if last:
                break
        pos = at + (4 if fhd & 4 else 0)                    # the content checksum
    return bytes(out[:need])
