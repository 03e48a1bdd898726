"""CCITT fax decoding for TIFF (compressions 2, 3 and 4), as libtiff's
tif_fax3.c decodes a strip or tile for PIL: Modified Huffman rows (2,
each row byte-aligned, no EOL), T.4 rows after an EOL, one-dimensional or,
with T4Options bit 0, each tagged 1D or 2D (3), and T.6 two-dimensional
rows against the row above, the first against a white row (4).

    bits = decode_fax(data, width, rows, compression, t4_options)   # (rows, width) uint8

A pixel is 1 where its run is black (the second run of a row, the fourth,
...), as libtiff fills its rows. Runs are read per code through 16-bit
lookahead tables (a per-symbol loop over a plain bit buffer, as
jpeg._decode_scan reads Huffman codes). Uncompressed mode (the extension
codes) is refused by name; data that ends early or holds no valid code
raises ValueError.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

# ITU-T T.4 Tables 2 and 3: terminating codes (runs 0-63), then make-up codes
# (64-1728), white and black, as bit strings
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
# make-up codes 1792-2560, the same for both colours
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 "
               "000000011110 000000011111").split()
_EOL = "000000000001"
# T.4 Table 4: two-dimensional mode codes -> (mode, vertical offset)
_MODES = {"0001": ("pass", 0), "001": ("horizontal", 0), "1": ("vertical", 0),
          "011": ("vertical", 1), "000011": ("vertical", 2), "0000011": ("vertical", 3),
          "010": ("vertical", -1), "000010": ("vertical", -2), "0000010": ("vertical", -3),
          "0000001": ("extension", 0), _EOL: ("eol", 0)}
_EOL_VALUE = -1


def _lut(codes: Dict[str, int]) -> List[int]:
    """Prefix codes -> a 65536-entry lookahead list: for the next 16 bits,
    (code length << 16) | (value + 2), or 0 where no code starts."""
    lut = np.zeros(1 << 16, np.int64)
    for bits, value in codes.items():
        n = len(bits)
        start = int(bits, 2) << (16 - n)
        lut[start:start + (1 << (16 - n))] = (n << 16) | (value + 2)
    return lut.tolist()


def _run_codes(term, makeup) -> Dict[str, int]:
    out = {c: i for i, c in enumerate(term)}
    out.update({c: 64 * (i + 1) for i, c in enumerate(makeup)})
    out.update({c: 1792 + 64 * i for i, c in enumerate(_EXT_MAKEUP)})
    out[_EOL] = _EOL_VALUE
    return out


@functools.lru_cache(maxsize=1)
def _tables() -> Tuple[List[int], List[int], List[int]]:
    """The white-run, black-run and mode lookahead tables."""
    modes = {code: i for i, code in enumerate(_MODES)}
    return (_lut(_run_codes(_WHITE_TERM, _WHITE_MAKEUP)),
            _lut(_run_codes(_BLACK_TERM, _BLACK_MAKEUP)), _lut(modes))


_MODE_LIST = list(_MODES.values())


class _Bits:
    """An MSB-first bit reader over bytes, zeros past the end (which ends
    a row early: the caller raises on running past `limit`)."""
    __slots__ = ("data", "pos", "limit")

    def __init__(self, data: bytes):
        self.data = data + bytes(4)
        self.pos, self.limit = 0, 8 * len(data)

    def peek16(self) -> int:
        byte, shift = self.pos >> 3, self.pos & 7
        d = self.data
        word = (d[byte] << 16) | (d[byte + 1] << 8) | d[byte + 2] if byte + 2 < len(d) else 0
        return (word >> (8 - shift)) & 0xFFFF

    def take(self, n: int) -> None:
        self.pos += n
        if self.pos > self.limit:
            raise ValueError("TIFF: CCITT data ends early")


def _code(bits: _Bits, lut: List[int], what: str) -> int:
    e = lut[bits.peek16()]
    if not e:
        raise ValueError(f"TIFF: corrupt CCITT data (no {what} code)")
    bits.take(e >> 16)
    return (e & 0xFFFF) - 2


def _run(bits: _Bits, lut: List[int]) -> int:
    """One run: make-up codes, then a terminating code (Figure 2 of T.4)."""
    total = 0
    while True:
        v = _code(bits, lut, "run")
        if v == _EOL_VALUE:
            raise ValueError("TIFF: corrupt CCITT data (an EOL inside a run)")
        total += v
        if v < 64:
            return total


def _row_1d(bits: _Bits, width: int, white: List[int], black: List[int]) -> List[int]:
    """A Modified Huffman row -> its changing elements."""
    changes, x, colour = [], 0, 0
    while x < width:
        x += _run(bits, black if colour else white)
        if x > width:
            raise ValueError("TIFF: corrupt CCITT data (a run past the row)")
        changes.append(x)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref: List[int], tables) -> List[int]:
    """A two-dimensional row against the reference row's changing elements
    (T.4 section 4.2, T.6): pass, horizontal and vertical modes."""
    white, black, modes = tables
    changes: List[int] = []
    a0, colour, i = -1, 0, 0
    ref = ref + [width] * 3
    while a0 < width:
        # b1: the first change right of a0 to the colour opposite a0's
        while ref[i] <= a0 and ref[i] < width or (i & 1) != colour:
            i += 1
        b1, b2 = ref[i], ref[i + 1]
        mode, d = _MODE_LIST[_code(bits, modes, "mode")]
        if mode == "pass":
            a0 = b2
            i += 2
        elif mode == "horizontal":
            start = max(a0, 0)
            a1 = start + _run(bits, black if colour else white)
            a2 = a1 + _run(bits, white if colour else black)
            if a2 > width:
                raise ValueError("TIFF: corrupt CCITT data (a run past the row)")
            changes += [a1, a2]
            a0 = a2
        elif mode == "vertical":
            a1 = b1 + d
            if a1 > width or a1 < max(a0, 0):
                raise ValueError("TIFF: corrupt CCITT data (a vertical code off the row)")
            changes.append(a1)
            a0, colour = a1, colour ^ 1
            i = max(i - 1, 0)
        elif mode == "extension":
            raise ValueError("TIFF: CCITT uncompressed mode is not decoded by the port")
        else:
            raise ValueError("TIFF: corrupt CCITT data (an EOL inside a row)")
    return changes


def _sync_eol(bits: _Bits) -> None:
    """libtiff's SYNC_EOL: find 11 zero bits, then the 1 ending the EOL
    (fill bits before an EOL are zeros)."""
    while bits.peek16() >> 5 != 0:
        bits.take(1)
    while not bits.peek16() >> 15:
        bits.take(1)
    bits.take(1)


def decode_fax(data: bytes, width: int, rows: int, compression: int,
               t4_options: int = 0) -> np.ndarray:
    """One strip or tile of CCITT data -> (rows, width) uint8, 1 where black."""
    tables = _tables()
    white, black, _ = tables
    bits = _Bits(bytes(data))
    out = np.zeros((rows, width), np.uint8)
    ref: List[int] = []                  # the white row above the first
    for y in range(rows):
        if compression == 2:
            changes = _row_1d(bits, width, white, black)
            bits.take(-bits.pos % 8)           # each row starts on a byte
        elif compression == 3:
            _sync_eol(bits)
            two_d = False
            if t4_options & 1:
                two_d = not bits.peek16() >> 15
                bits.take(1)
            changes = _row_2d(bits, width, ref, tables) if two_d else _row_1d(
                bits, width, white, black)
        else:
            changes = _row_2d(bits, width, ref, tables)
        edges = np.array([0] + changes + [width] * (len(changes) % 2 + 1))
        row = out[y]
        for a, b in zip(edges[1::2], edges[2::2]):
            row[a:b] = 1
        ref = [c for c in changes if c < width]
    return out
