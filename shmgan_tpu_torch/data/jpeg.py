"""JPEG decoding in numpy and the standard library: what the JAX package gets
from PIL's `Image.open(...).convert("RGB")`, which is libjpeg-turbo's default
decompression (islow IDCT, fancy upsampling), pixel for pixel.

    rgb = decode_jpeg(data)     # (H, W, 3) uint8; a greyscale file replicated

Read: baseline and extended sequential Huffman (SOF0, SOF1), progressive
Huffman (SOF2), arithmetic-coded sequential and progressive (SOF9, SOF10,
with DAC's conditioning, as libjpeg-turbo's jdarith.c decodes them) files
of 8-bit samples with 1, 3 or 4 components, integral sampling factors,
restart intervals, 8- and 16-bit quantisation tables; lossless files
(SOF3, predictors 1-7, a point transform, unsubsampled components, as
libjpeg-turbo 3's jdlossls.c undifferences them). APPn and COM segments
are skipped, EXIF orientation is not applied (PIL's `Image.open` does not
apply it either); an Adobe APP14 segment of transform 0, or component ids
'R', 'G', 'B', means RGB samples, as libjpeg decides, and so does a
lossless file with neither JFIF nor Adobe segment (libjpeg-turbo 3).
Four components are CMYK (Adobe transform 0, or no Adobe segment) or YCCK
(any other transform; jdcolor.c's ycck_cmyk_convert), which PIL reads as
Adobe's inverted CMYK ("CMYK;I") and turns to RGB with its cmyk2rgb.
`jpeg_planes` gives a stream's upsampled components without colour
conversion, after a tables-only stream (JPEG-in-TIFF). Refused with a
ValueError that names the feature: 12-bit precision, hierarchical JPEG
(SOF5-SOF7, DHP, SOF13-SOF15) and lossless arithmetic coding (SOF11),
which PIL's libjpeg-turbo refuses too; a lossless file of YCbCr samples
(libjpeg-turbo converts no colour in lossless mode, so PIL refuses it
too); subsampled lossless components. A file cut short or corrupt raises
ValueError (PIL raises OSError there).

Two halves:

  - entropy decoding (`_decode_scan` for Huffman, `_decode_scan_arith` for
    the QM coder, `_decode_lossless`): a per-symbol Python loop over 16-bit
    lookahead tables or statistics bins that fills one flat int32
    coefficient buffer a component (64 coefficients a block, zigzag
    order) for the whole image. Its inputs are plain lists and buffers, so
    it can move to C unchanged in what it reads and writes;
  - the back half (`_reconstruct`): dequantisation, libjpeg's integer islow
    IDCT (jidctint.c), its "fancy" triangle upsampling (jdsample.c h2v1,
    h2v2 and h1v2) and its fixed-point YCbCr->RGB tables (jdcolor.c),
    vectorised in numpy over all blocks and whole planes at once.
"""

from __future__ import annotations

import re
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

# zigzag index k -> natural (row-major) position of the 8x8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZIGZAG = np.argsort(_NATURAL)        # natural position -> zigzag index

_REFUSED = {
    0xC5: "hierarchical JPEG (SOF5), which PIL's libjpeg-turbo refuses too",
    0xC6: "hierarchical JPEG (SOF6), which PIL's libjpeg-turbo refuses too",
    0xC7: "hierarchical JPEG (SOF7), which PIL's libjpeg-turbo refuses too",
    0xDE: "hierarchical JPEG (DHP), which PIL's libjpeg-turbo refuses too",
    0xCB: "lossless arithmetic-coded JPEG (SOF11), which PIL's libjpeg-turbo refuses too",
    0xCD: "hierarchical arithmetic-coded JPEG (SOF13), which PIL's libjpeg-turbo refuses too",
    0xCE: "hierarchical arithmetic-coded JPEG (SOF14), which PIL's libjpeg-turbo refuses too",
    0xCF: "hierarchical arithmetic-coded JPEG (SOF15), which PIL's libjpeg-turbo refuses too",
}
# start-of-frame markers read: marker -> (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
        0xC9: (False, True, False), 0xCA: (True, True, False), 0xC3: (False, False, True)}
# a marker after any fill bytes: every 0xFF not followed by a stuffed 0x00
_MARKER = re.compile(rb"\xff+([^\x00\xff])")

# jdcolor.c: FIX(x) in 16 fractional bits
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "bw", "bh", "coefs", "dw", "dh", "samples")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None     # latched at the component's first scan, as libjpeg does
        self.samples = None   # a lossless frame's decoded plane


def _segment(data: bytes, pos: int) -> Tuple[int, bytes]:
    """The (marker, body) of the length-prefixed segment whose length starts
    at `pos`."""
    if pos + 2 > len(data):
        raise ValueError("JPEG: truncated (segment header cut off)")
    n = (data[pos] << 8) | data[pos + 1]
    if n < 2 or pos + n > len(data):
        raise ValueError("JPEG: truncated (segment cut off)")
    return pos + n, data[pos + 2:pos + n]


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """JPEG Annex C canonical codes -> a 65536-entry lookahead list: for the
    next 16 bits of the stream, (code length << 8) | symbol, or 0 for a bit
    pattern that starts no code."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("JPEG: corrupt Huffman table")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _words(seg: bytes) -> List[int]:
    """Entropy-coded bytes (unstuffed) as big-endian 32-bit words, two words
    of zeros past the end (libjpeg feeds zeros past the data too)."""
    return np.frombuffer(seg + bytes((-len(seg)) % 4 + 8), ">u4").tolist()


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `pos` up to the next marker that is not a
    restart marker: its pieces between restart markers, unstuffed, and the
    position of that marker."""
    segs, start = [], pos
    for m in _MARKER.finditer(data, pos):
        code = m.group(1)[0]
        segs.append(data[start:m.start()].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= code <= 0xD7:
            start = m.end()
            continue
        return segs, m.start()
    raise ValueError("JPEG: truncated (entropy-coded data runs to the end of the file)")


def _decode_scan(segments: List[bytes], order: List[Tuple[int, int]], blocks_per_mcu: int,
                 restart: int, comps: List[array], dc_luts: List[Optional[List[int]]],
                 ac_luts: List[Optional[List[int]]], ss: int, se: int, ah: int, al: int,
                 progressive: bool) -> None:
    """Entropy-decode one scan into the coefficient buffers `comps` (flat
    int32, 64 a block, zigzag order). `order` lists (component, block offset)
    in coding order; every `restart` MCUs (0: never) the next segment starts
    with fresh predictors and an empty EOB run. Sequential scans decode
    whole blocks; progressive ones are the four kinds of jdphuff.c (DC first
    and refinement, AC first and refinement)."""
    n_blocks = len(order)
    per_seg = restart * blocks_per_mcu if restart else n_blocks
    if len(segments) < -(-n_blocks // per_seg):
        raise ValueError("JPEG: truncated (restart intervals missing)")
    p1, m1 = 1 << al, -1 << al
    for si in range(-(-n_blocks // per_seg)):
        seg = segments[si]
        words = _words(seg)
        wi, acc, nb = 0, 0, 0
        pred = [0] * len(comps)
        eobrun = 0
        try:
            for ci, base in order[si * per_seg:(si + 1) * per_seg]:
                out = comps[ci]
                if not progressive or (ss == 0 and ah == 0):
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    e = dc_luts[ci][(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: corrupt data (bad Huffman code)")
                    nb -= e >> 8
                    s = e & 0xFF
                    if s:
                        if s > 16:     # nb >= 16 here: a valid category needs no refill
                            raise ValueError("JPEG: corrupt data (DC magnitude)")
                        nb -= s
                        val = (acc >> nb) & ((1 << s) - 1)
                        if val < (1 << (s - 1)):
                            val -= (1 << s) - 1
                        pred[ci] += val
                    if not progressive:
                        out[base] = pred[ci]
                    else:
                        out[base] = pred[ci] << al
                        continue
                elif ss == 0:
                    # DC refinement: one bit a block
                    if nb < 1:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    nb -= 1
                    if (acc >> nb) & 1:
                        out[base] |= p1
                    continue
                if not progressive:
                    k, end = 1, 63
                else:
                    k, end = ss, se
                act = ac_luts[ci]
                if not progressive or ah == 0:
                    # whole block (sequential) or AC first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    while k <= end:
                        if nb < 32:
                            acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                            wi += 1
                            nb += 32
                        e = act[(acc >> (nb - 16)) & 0xFFFF]
                        if not e:
                            raise ValueError("JPEG: corrupt data (bad Huffman code)")
                        nb -= e >> 8
                        s = e & 15
                        r = (e >> 4) & 15
                        if s:
                            k += r
                            if k > 63:
                                raise ValueError("JPEG: corrupt data (coefficient past 63)")
                            nb -= s
                            val = (acc >> nb) & ((1 << s) - 1)
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            out[base + k] = val << al if progressive else val
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            if progressive:
                                eobrun = 1 << r
                                if r:
                                    nb -= r
                                    eobrun += (acc >> nb) & ((1 << r) - 1)
                                eobrun -= 1
                            break
                    continue
                # AC refinement (jdphuff.c decode_mcu_AC_refine)
                if not eobrun:
                    while k <= end:
                        if nb < 32:
                            acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                            wi += 1
                            nb += 32
                        e = act[(acc >> (nb - 16)) & 0xFFFF]
                        if not e:
                            raise ValueError("JPEG: corrupt data (bad Huffman code)")
                        nb -= e >> 8
                        s = e & 15
                        r = (e >> 4) & 15
                        if s:
                            nb -= 1
                            s = p1 if (acc >> nb) & 1 else m1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                nb -= r
                                eobrun += (acc >> nb) & ((1 << r) - 1)
                            break
                        while k <= end:
                            c = out[base + k]
                            if c:
                                if nb < 1:
                                    acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                                    wi += 1
                                    nb += 32
                                nb -= 1
                                if (acc >> nb) & 1 and not c & p1:
                                    out[base + k] = c + p1 if c >= 0 else c + m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("JPEG: corrupt data (coefficient past 63)")
                            out[base + k] = s
                        k += 1
                if eobrun:
                    while k <= end:
                        c = out[base + k]
                        if c:
                            if nb < 1:
                                acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                                wi += 1
                                nb += 32
                            nb -= 1
                            if (acc >> nb) & 1 and not c & p1:
                                out[base + k] = c + p1 if c >= 0 else c + m1
                        k += 1
                    eobrun -= 1
        except IndexError:
            raise ValueError("JPEG: truncated (entropy-coded data ends early)") from None
        if 32 * wi - nb > 8 * len(seg):
            raise ValueError("JPEG: truncated (entropy-coded data ends early)")


# jaricom.c: the QM coder's probability states (ITU-T T.81 Table D.2), each
# (Qe, next state after an LPS, next state after an MPS, switch MPS), and
# state 113, the fixed estimate of one half (ITU-T T.851)
_QE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
)
# a state byte: bit 7 the MPS, bits 0-6 the state index (jdarith.c's packing)
_AQE = [q for q, _, _, _ in _QE]
_ANL = [(sw << 7) | lps for _, lps, _, sw in _QE]
_ANM = [mps for _, _, mps, _ in _QE]
_FIXED = 113
_DC_BINS, _AC_BINS = 64, 256


class _Arith:
    """jdarith.c's decoder over one restart interval: arith_decode reads
    one binary decision in a statistics bin (an index into `stats`, a
    bytearray of state bytes), fed zeros past the end of the data as
    libjpeg feeds them at a marker."""
    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def decode(self, stats: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    byte = self.data[self.pos]
                    self.pos += 1
                else:
                    byte = 0
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000          # two initial bytes read
            a <<= 1
        sv = stats[i]
        qe = _AQE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                stats[i] = (sv & 0x80) ^ _ANM[sv & 0x7F]
            else:
                a = qe
                stats[i] = (sv & 0x80) ^ _ANL[sv & 0x7F]
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ _ANL[sv & 0x7F]
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ _ANM[sv & 0x7F]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_magnitude(d: _Arith, st: bytearray, i: int, upper: int) -> int:
    """Figures F.23 and F.24: a nonzero value's magnitude category from bin
    i (then `upper`'s chain), and its magnitude bits 14 bins on: |v| - 1."""
    m = d.decode(st, i)
    if m:
        if upper < 0:                       # DC: the category chain starts at X1 = 20
            i = 20
            while d.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG: corrupt data (arithmetic magnitude overflow)")
                i += 1
        elif d.decode(st, i):
            m <<= 1
            i = upper
            while d.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG: corrupt data (arithmetic magnitude overflow)")
                i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if d.decode(st, i):
            v |= m
        m >>= 1
    return v


def _decode_scan_arith(segments: List[bytes], order: List[Tuple[int, int]],
                       blocks_per_mcu: int, restart: int, comps: List[array],
                       dc_tbl: List[int], ac_tbl: List[int], cond: Dict[int, int],
                       ss: int, se: int, ah: int, al: int, progressive: bool) -> None:
    """Decode one arithmetic-coded scan into the coefficient buffers, as
    libjpeg-turbo's jdarith.c does: sequential blocks (decode_mcu) or the
    four progressive kinds, statistics zeroed at the scan's start and at
    every restart. `cond` holds DAC's conditioning values (DC tables 0-3:
    L | U << 4, default 0x10; AC tables 16-19: K, default 5)."""
    n_blocks = len(order)
    per_seg = restart * blocks_per_mcu if restart else n_blocks
    if len(segments) < -(-n_blocks // per_seg):
        raise ValueError("JPEG: truncated (restart intervals missing)")
    do_dc = not progressive or (ss == 0 and ah == 0)
    do_ac = not progressive or ss > 0
    p1, m1 = 1 << al, -1 << al
    fixed = bytearray([_FIXED])
    for si in range(-(-n_blocks // per_seg)):
        d = _Arith(segments[si])
        dc_stats = {t: bytearray(_DC_BINS) for t in set(dc_tbl) if t >= 0} if do_dc else {}
        ac_stats = {t: bytearray(_AC_BINS) for t in set(ac_tbl) if t >= 0} if do_ac else {}
        last = [0] * len(comps)
        ctx = [0] * len(comps)
        for ci, base in order[si * per_seg:(si + 1) * per_seg]:
            out = comps[ci]
            if not progressive or ss == 0:
                if progressive and ah:          # DC refinement: one bit, fixed estimate
                    if d.decode(fixed, 0):
                        out[base] |= p1
                    continue
                st, t = dc_stats[dc_tbl[ci]], dc_tbl[ci]
                i = ctx[ci]
                if d.decode(st, i) == 0:
                    ctx[ci] = 0
                else:
                    sign = d.decode(st, i + 1)
                    m_i = i + 2 + sign
                    v = _arith_magnitude(d, st, m_i, -1)
                    mag = 1 << (v.bit_length() - 1) if v else 0   # Figure F.23's m
                    lo, hi = cond.get(t, 0x10) & 15, cond.get(t, 0x10) >> 4
                    if mag < (1 << lo) >> 1:
                        ctx[ci] = 0
                    elif mag > (1 << hi) >> 1:
                        ctx[ci] = 12 + sign * 4
                    else:
                        ctx[ci] = 4 + sign * 4
                    v += 1
                    last[ci] = (last[ci] + (-v if sign else v)) & 0xFFFF
                dc = last[ci] - 0x10000 if last[ci] & 0x8000 else last[ci]
                if progressive:
                    out[base] = dc << al
                    continue
                out[base] = dc
            st, t = ac_stats[ac_tbl[ci]], ac_tbl[ci]
            kx = cond.get(16 + t, 5)
            if not progressive:
                k = 0
                while k < 63:
                    i = 3 * k
                    if d.decode(st, i):
                        break                       # EOB
                    while True:
                        k += 1
                        if d.decode(st, i + 1):
                            break
                        i += 3
                        if k >= 63:
                            raise ValueError("JPEG: corrupt data (arithmetic spectral "
                                             "overflow)")
                    sign = d.decode(fixed, 0)
                    v = _arith_magnitude(d, st, i + 2, 189 if k <= kx else 217) + 1
                    out[base + k] = -v if sign else v
                continue
            if ah == 0:                              # AC first
                k = ss
                while k <= se:
                    i = 3 * (k - 1)
                    if d.decode(st, i):
                        break
                    while not d.decode(st, i + 1):
                        i += 3
                        k += 1
                        if k > se:
                            raise ValueError("JPEG: corrupt data (arithmetic spectral "
                                             "overflow)")
                    sign = d.decode(fixed, 0)
                    v = _arith_magnitude(d, st, i + 2, 189 if k <= kx else 217) + 1
                    out[base + k] = (-v if sign else v) * p1
                    k += 1
                continue
            # AC refinement (decode_mcu_AC_refine)
            kex = se
            while kex > 0 and not out[base + kex]:
                kex -= 1
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if k > kex and d.decode(st, i):
                    break
                while True:
                    c = out[base + k]
                    if c:
                        if d.decode(st, i + 2):
                            out[base + k] = c + (m1 if c < 0 else p1)
                        break
                    if d.decode(st, i + 1):
                        out[base + k] = m1 if d.decode(fixed, 0) else p1
                        break
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError("JPEG: corrupt data (arithmetic spectral overflow)")
                k += 1


def _decode_lossless(segments: List[bytes], comps: List[_Component], scan: List[int],
                     luts: List[Optional[List[int]]], restart: int, psv: int, pt: int,
                     width: int, height: int) -> None:
    """One lossless (SOF3) scan, as libjpeg-turbo 3's jdlhuff.c and
    jdlossls.c decode it: each sample's difference Huffman-coded as a DC
    difference (category 16: 32768), the scan's components interleaved one
    sample each; then undifferenced row by row modulo 2 ** 16 with
    predictor `psv` (the first row of the scan and of each restart
    interval from its left neighbour, its first sample from
    2 ** (7 - pt); each row's first sample from the one above), and
    scaled by 2 ** pt into 8-bit samples."""
    n = width * height
    if restart and restart % width:
        raise ValueError("JPEG: a lossless restart interval that is not whole rows is refused "
                         "by PIL's libjpeg-turbo too")
    per_seg = restart if restart else n
    if len(segments) < -(-n // per_seg):
        raise ValueError("JPEG: truncated (restart intervals missing)")
    diffs = [array("i", [0]) * n for _ in scan]
    for si in range(-(-n // per_seg)):
        seg = segments[si]
        words = _words(seg)
        wi, acc, nb = 0, 0, 0
        try:
            for m in range(si * per_seg, min(n, (si + 1) * per_seg)):
                for j, ci in enumerate(scan):
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    e = luts[ci][(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: corrupt data (bad Huffman code)")
                    nb -= e >> 8
                    s = e & 0xFF
                    if s == 16:
                        val = 32768
                    elif s:
                        if s > 16:
                            raise ValueError("JPEG: corrupt data (lossless difference "
                                             "category)")
                        nb -= s
                        val = (acc >> nb) & ((1 << s) - 1)
                        if val < (1 << (s - 1)):
                            val -= (1 << s) - 1
                    else:
                        val = 0
                    diffs[j][m] = val
        except IndexError:
            raise ValueError("JPEG: truncated (entropy-coded data ends early)") from None
        if 32 * wi - nb > 8 * len(seg):
            raise ValueError("JPEG: truncated (entropy-coded data ends early)")
    first_rows = set(range(0, height, per_seg // width))
    for j, ci in enumerate(scan):
        d, out = diffs[j], [0] * n
        for y in range(height):
            row = y * width
            if y in first_rows:             # undifference_first_row: predictor 1
                ra = (d[row] + (1 << (7 - pt))) & 0xFFFF
                out[row] = ra
                for x in range(1, width):
                    ra = (d[row + x] + ra) & 0xFFFF
                    out[row + x] = ra
                continue
            up = row - width
            rb = out[up]
            ra = (d[row] + rb) & 0xFFFF
            out[row] = ra
            for x in range(1, width):
                rc, rb = rb, out[up + x]
                if psv == 1:
                    pred = ra
                elif psv == 2:
                    pred = rb
                elif psv == 3:
                    pred = rc
                elif psv == 4:
                    pred = ra + rb - rc
                elif psv == 5:
                    pred = ra + ((rb - rc) >> 1)
                elif psv == 6:
                    pred = rb + ((ra - rc) >> 1)
                else:
                    pred = (ra + rb) >> 1
                ra = (d[row + x] + pred) & 0xFFFF
                out[row + x] = ra
        plane = (np.asarray(out, np.int64) << pt) & 0xFF
        comps[ci].samples = plane.reshape(height, width).astype(np.int32)


def _scan_order(comps: List[_Component], scan: List[int], hmax: int, vmax: int,
                width: int, height: int) -> Tuple[List[Tuple[int, int]], int]:
    """(component, block offset) in coding order, and blocks an MCU. One
    component: its own blocks row by row (the MCU is one block); several:
    MCUs of h x v blocks of each, over the frame's MCU grid."""
    if len(scan) == 1:
        c = comps[scan[0]]
        cols = -(-c.dw // 8)
        rows = -(-c.dh // 8)
        by, bx = np.mgrid[0:rows, 0:cols]
        offs = ((by * c.bw + bx) * 64).ravel()
        return [(scan[0], int(o)) for o in offs.tolist()], 1
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    parts = []
    for ci in scan:
        c = comps[ci]
        my, mx, i, j = np.mgrid[0:mcuy, 0:mcux, 0:c.v, 0:c.h]
        offs = ((my * c.v + i) * c.bw + mx * c.h + j) * 64
        parts.append((ci, offs.reshape(mcuy * mcux, c.v * c.h)))
    order = []
    per_mcu = [(ci, o.tolist()) for ci, o in parts]
    for m in range(mcuy * mcux):
        for ci, o in per_mcu:
            order.extend((ci, b) for b in o[m])
    return order, sum(comps[ci].h * comps[ci].v for ci in scan)


# -- the back half ---------------------------------------------------------------

def _idct_1d(x, shift):
    """jidctint.c's islow 1-D pass (CONST_BITS 13) on eight int64 arrays,
    descaled by `shift` with rounding."""
    z1 = (x[2] + x[6]) * 4433                         # FIX_0_541196100
    tmp2 = z1 + x[6] * -15137                         # FIX_1_847759065
    tmp3 = z1 + x[2] * 6270                           # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                             # FIX_1_175875602
    t0 = t0 * 2446                                    # FIX_0_298631336
    t1 = t1 * 16819                                   # FIX_2_053119869
    t2 = t2 * 25172                                   # FIX_3_072711026
    t3 = t3 * 12299                                   # FIX_1_501321110
    z1 = z1 * -7373                                   # FIX_0_899976223
    z2 = z2 * -20995                                  # FIX_2_562915447
    z3 = z3 * -16069 + z5                             # FIX_1_961570560
    z4 = z4 * -3196 + z5                              # FIX_0_390180644
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(N, 64) dequantised coefficients, natural order -> (N, 8, 8) uint8
    samples: columns then rows (PASS1_BITS 2), libjpeg's range limit (the
    sum wraps mod 1024 before it is clamped, as its table does)."""
    c = coefs.reshape(-1, 8, 8)
    ws = _idct_1d([c[:, k, :] for k in range(8)], 13 - 2)
    ws = [w.astype(np.int32).astype(np.int64) for w in ws]   # the int workspace
    rows = [np.stack([ws[k][:, col] for k in range(8)], 1) for col in range(8)]
    # rows[col] is (N, 8 output rows); pass 2 runs along each output row
    out = _idct_1d(rows, 13 + 2 + 3)
    px = np.stack(out, -1)                                   # (N, 8 rows, 8 cols)
    px = px & 1023
    px = np.where(px >= 512, px - 1024, px) + 128
    return np.clip(px, 0, 255).astype(np.uint8)


def _plane(c: _Component) -> np.ndarray:
    """A component's coefficients -> its sample plane, cropped to its
    downsampled size."""
    coefs = np.frombuffer(c.coefs, np.int32).reshape(-1, 64)
    deq = coefs.astype(np.int16).astype(np.int64) * np.asarray(c.quant, np.int64)[None]
    px = _idct_islow(deq[:, _ZIGZAG])
    px = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
    return px[:c.dh, :c.dw]


def _fancy_h(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample on int32 rows: 3/4 nearer + 1/4 further,
    edges replicated, biases 1 and 2."""
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_v(x: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's h1v2_fancy_upsample: the row above for the upper
    output row (bias 1), the row below for the lower (bias 2)."""
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _fancy_hv(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample: column sums 3 * nearer row + further
    row, then 3/4 nearer + 1/4 further column sum, biases 8 and 7."""
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, other in ((0, up), (1, down)):
        s = 3 * x + other
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out


def _upsample(p: np.ndarray, c: _Component, hmax: int, vmax: int, width: int,
              height: int) -> np.ndarray:
    """A downsampled plane to the full frame, as jinit_upsampler picks: the
    fancy filters for 2:1 ratios (h2v1 and h2v2 only when the plane is wider
    than 2), box replication for every other integral ratio."""
    fh, fv = hmax // c.h, vmax // c.v
    x = p.astype(np.int32)
    if (fh, fv) == (2, 1) and c.dw > 2:
        x = _fancy_h(x)
    elif (fh, fv) == (1, 2):
        x = _fancy_v(x)
    elif (fh, fv) == (2, 2) and c.dw > 2:
        x = _fancy_hv(x)
    elif (fh, fv) != (1, 1):
        x = np.repeat(np.repeat(x, fv, 0), fh, 1)
    return x[:height, :width]


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its tables (SCALEBITS 16)."""
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# -- markers ----------------------------------------------------------------------

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB."""
    return _reconstruct(*_read(bytes(data)))


def jpeg_planes(data: bytes, tables: bytes = b"", limit=None) -> List[np.ndarray]:
    """A JPEG stream's components, each upsampled to the full frame (int32,
    (H, W)), with no colour conversion: what libjpeg gives for an unknown
    colour space (libtiff's JPEG codec). `tables` is a tables-only stream
    (TIFF's JPEGTables) read before `data`, which may then omit its
    quantisation and Huffman tables; a frame wider or taller than `limit`
    (w, h) is refused before anything is allocated for it."""
    comps, frame, _, _ = _read(bytes(data), bytes(tables), limit)
    return _planes(comps, frame)


def _read(data: bytes, tables: bytes = b"", limit=None):
    """Parse and entropy-decode a JPEG stream (after a tables-only stream,
    if given): (components, frame, JFIF seen, Adobe transform)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI marker")
    qtables: Dict[int, List[int]] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    if tables:
        if tables[:2] != b"\xff\xd8":
            raise ValueError("JPEG: tables without an SOI marker")
        _tables_only(tables, qtables, dc_tabs, ac_tabs)
    comps: List[_Component] = []
    frame = None           # (width, height, progressive, arithmetic, lossless)
    cond: Dict[int, int] = {}      # DAC: table index -> conditioning value
    restart = 0
    jfif, adobe = False, None
    pos = 2
    while True:
        m = _MARKER.search(data, pos)      # libjpeg skips stray bytes before a marker
        if m is None:
            raise ValueError("JPEG: truncated (no EOI marker)")
        marker, pos = m.group(1)[0], m.end()
        if marker == 0xD9:
            break
        if marker in _REFUSED:
            raise ValueError(f"JPEG: {_REFUSED[marker]} is not decoded by the port")
        if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
            continue                                   # TEM, stray RSTn/SOI: no body
        pos, body = _segment(data, pos)
        if marker in _SOF:
            if frame is not None:
                raise ValueError("JPEG: corrupt data (two frames)")
            if len(body) < 6:
                raise ValueError("JPEG: corrupt frame header")
            precision, height, width, nc = body[0], (body[1] << 8) | body[2], \
                (body[3] << 8) | body[4], body[5]
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit precision is not decoded by the port"
                                 + (" (PIL's libjpeg-turbo, built for 8 bits, refuses it "
                                    "too)" if precision == 12 else ""))
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG: {nc}-component files are not decoded by the port")
            if height == 0:
                raise ValueError("JPEG: a height defined by a DNL marker is not decoded "
                                 "by the port")
            if width == 0 or len(body) < 6 + 3 * nc:
                raise ValueError("JPEG: corrupt frame header")
            check_size("JPEG", width, height)
            if limit and (width > limit[0] or height > limit[1]):
                raise ValueError(f"TIFF: a JPEG strip or tile of {width}x{height}, past its "
                                 f"{limit[0]}x{limit[1]}, is refused by libtiff too")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise ValueError("JPEG: corrupt frame header (sampling factors)")
                comps.append(_Component(cid, h, v, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise ValueError("JPEG: non-integral sampling ratios are not decoded "
                                     "by the port")
                c.dw = -(-width * c.h // hmax)
                c.dh = -(-height * c.v // vmax)
                c.bw = -(-width // (8 * hmax)) * c.h
                c.bh = -(-height // (8 * vmax)) * c.v
                c.coefs = array("i", [0]) * (64 * c.bw * c.bh)
            frame = (width, height) + _SOF[marker]
            if frame[4] and any((c.h, c.v) != (1, 1) for c in comps):
                raise ValueError("JPEG: lossless JPEG with subsampled components is not "
                                 "decoded by the port")
        elif marker in (0xC4, 0xDB):
            _table(marker, body, qtables, dc_tabs, ac_tabs)
        elif marker == 0xCC:                           # DAC: arithmetic conditioning
            if len(body) % 2:
                raise ValueError("JPEG: corrupt DAC segment")
            for i in range(0, len(body), 2):
                index, val = body[i], body[i + 1]
                if index >= 32 or index < 16 and (val & 15) > (val >> 4):
                    raise ValueError("JPEG: corrupt DAC segment")
                cond[index] = val
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("JPEG: corrupt restart interval")
            restart = (body[0] << 8) | body[1]
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\x00")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: corrupt data (scan before frame)")
            pos = _sos(data, pos, body, comps, frame, qtables, dc_tabs, ac_tabs, restart, cond)
    if frame is None:
        raise ValueError("JPEG: no frame")
    return comps, frame, jfif, adobe


def _table(marker, body, qtables, dc_tabs, ac_tabs) -> None:
    """A DHT (0xC4) or DQT (0xDB) segment's tables into the dicts."""
    i = 0
    if marker == 0xC4:
        while i < len(body):
            if i + 17 > len(body):
                raise ValueError("JPEG: corrupt Huffman table")
            tc_th, counts = body[i], body[i + 1:i + 17]
            n = sum(counts)
            symbols = body[i + 17:i + 17 + n]
            if len(symbols) != n or (tc_th & 15) > 3 or tc_th >> 4 > 1:
                raise ValueError("JPEG: corrupt Huffman table")
            (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = _huffman_lut(counts, symbols)
            i += 17 + n
        return
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or i + 1 + size > len(body):
            raise ValueError("JPEG: corrupt quantisation table")
        raw = np.frombuffer(body, ">u2" if pq else np.uint8, 64, i + 1)
        qtables[tq] = raw.astype(np.int64).tolist()
        i += 1 + size


def _tables_only(data, qtables, dc_tabs, ac_tabs) -> None:
    """A tables-only stream (SOI, DQT and DHT segments, EOI)."""
    pos = 2
    while True:
        m = _MARKER.search(data, pos)
        if m is None:
            raise ValueError("JPEG: truncated tables (no EOI marker)")
        marker, pos = m.group(1)[0], m.end()
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        pos, body = _segment(data, pos)
        if marker in (0xC4, 0xDB):
            _table(marker, body, qtables, dc_tabs, ac_tabs)
        elif 0xC0 <= marker <= 0xCF or marker == 0xDA:
            raise ValueError("JPEG: a frame or scan in a tables-only stream")


def _sos(data, pos, body, comps, frame, qtables, dc_tabs, ac_tabs, restart, cond) -> int:
    """One scan: its header, then its entropy-coded data. Returns the
    position of the marker after it."""
    width, height, progressive, arith, lossless = frame
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise ValueError("JPEG: corrupt scan header")
    ids = {c.cid: i for i, c in enumerate(comps)}
    scan, dcl, acl = [], [None] * len(comps), [None] * len(comps)
    dct, act = [-1] * len(comps), [-1] * len(comps)
    ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    for i in range(ns):
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        if cs not in ids:
            raise ValueError("JPEG: corrupt scan header (unknown component)")
        ci = ids[cs]
        scan.append(ci)
        c = comps[ci]
        if c.quant is None:
            if lossless:
                c.quant = [1] * 64
            elif c.tq not in qtables:
                raise ValueError("JPEG: corrupt data (quantisation table missing)")
            else:
                c.quant = qtables[c.tq]
        need_dc = lossless or not progressive or (ss == 0 and ah == 0)
        need_ac = not lossless and (not progressive or ss > 0)
        if (t >> 4) > 3 or (t & 15) > 3:
            raise ValueError("JPEG: corrupt scan header (table index)")
        dct[ci], act[ci] = t >> 4, t & 15
        if arith:
            continue
        if need_dc:
            if (t >> 4) not in dc_tabs:
                raise ValueError("JPEG: corrupt data (Huffman table missing)")
            dcl[ci] = dc_tabs[t >> 4]
        if need_ac:
            if (t & 15) not in ac_tabs:
                raise ValueError("JPEG: corrupt data (Huffman table missing)")
            acl[ci] = ac_tabs[t & 15]
    if progressive:
        if ss == 0 and se != 0 or ss > se or se > 63 or (ss > 0 and ns != 1) or al > 13:
            raise ValueError("JPEG: corrupt progressive scan parameters")
    segments, end = _scan_segments(data, pos)
    if lossless:
        if not 1 <= ss <= 7 or al > 7:
            raise ValueError("JPEG: corrupt lossless scan parameters")
        _decode_lossless(segments, comps, scan, dcl, restart, ss, al, width, height)
        return end
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    order, per_mcu = _scan_order(comps, scan, hmax, vmax, width, height)
    if arith:
        _decode_scan_arith(segments, order, per_mcu, restart, [c.coefs for c in comps],
                           dct, act, cond, ss, se, ah, al, progressive)
    else:
        _decode_scan(segments, order, per_mcu, restart, [c.coefs for c in comps], dcl, acl,
                     ss, se, ah, al, progressive)
    return end


def _planes(comps: List[_Component], frame) -> List[np.ndarray]:
    width, height = frame[:2]
    if any(c.quant is None for c in comps):
        raise ValueError("JPEG: truncated (a component has no scan)")
    if frame[4]:
        return [c.samples for c in comps]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    return [_upsample(_plane(c), c, hmax, vmax, width, height) for c in comps]


def _reconstruct(comps: List[_Component], frame, jfif: bool, adobe: Optional[int]
                 ) -> np.ndarray:
    planes = _planes(comps, frame)
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    if len(planes) == 4:
        if frame[4] and adobe:
            raise ValueError("JPEG: a lossless YCCK file is refused by PIL too (libjpeg-turbo "
                             "converts no colour in lossless mode)")
        return _cmyk_to_rgb(planes, adobe)
    # jdapimin.c default_decompress_parms: JFIF, then Adobe, then component ids
    # ('R', 'G', 'B'), and libjpeg-turbo 3 takes lossless files as RGB otherwise
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66] or frame[4]
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    if frame[4]:
        raise ValueError("JPEG: a lossless file of YCbCr samples (a JFIF or Adobe segment) is "
                         "refused by PIL too (libjpeg-turbo converts no colour in lossless "
                         "mode)")
    return ycc_to_rgb(*planes)


def _cmyk_to_rgb(planes: List[np.ndarray], adobe: Optional[int]) -> np.ndarray:
    """Four components, as libjpeg reads them (jdapimin.c: Adobe transform 0
    or no Adobe segment is CMYK, any other transform YCCK, which jdcolor.c's
    ycck_cmyk_convert turns to CMYK), then as PIL takes them: inverted
    (JpegImagePlugin's rawmode "CMYK;I", Adobe's convention) and through
    Convert.c's cmyk2rgb, nk - nk * c / 255 with nk = 255 - k, in its
    MULDIV255 rounding."""
    c, m, y, k = (p.astype(np.int64) for p in planes)
    if adobe is not None and adobe != 0:
        lum, cb, cr = c, m - 128, y - 128
        c = 255 - (lum + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS))
        m = 255 - (lum + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr)
                          >> _SCALEBITS))
        y = 255 - (lum + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS))
    cmy = 255 - np.clip(np.stack([c, m, y], -1), 0, 255)
    nk = k[..., None]                  # 255 - the inverted k
    t = cmy * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
