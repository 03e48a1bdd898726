"""JPEG decoding in numpy and the standard library: what the JAX package gets
from PIL's `Image.open(...).convert("RGB")`, which is libjpeg-turbo's default
decompression (islow IDCT, fancy upsampling), pixel for pixel.

    rgb = decode_jpeg(data)     # (H, W, 3) uint8; a greyscale file replicated

Read: baseline and extended sequential Huffman (SOF0, SOF1) and progressive
Huffman (SOF2) files of 8-bit samples with 1, 3 or 4 components, integral
sampling factors, restart intervals, 8- and 16-bit quantisation tables.
APPn and COM segments are skipped, EXIF orientation is not applied (PIL's
`Image.open` does not apply it either); an Adobe APP14 segment of transform
0, or component ids 'R', 'G', 'B', means RGB samples, as libjpeg decides.
Four components are CMYK (Adobe transform 0, or no Adobe segment) or YCCK
(any other transform; jdcolor.c's ycck_cmyk_convert), which PIL reads as
Adobe's inverted CMYK ("CMYK;I") and turns to RGB with its cmyk2rgb.
Refused with a ValueError that names the feature: arithmetic coding
(SOF9-SOF15, DAC; PIL's libjpeg-turbo has that decoder, the port does not),
12-bit precision, lossless (SOF3) and hierarchical (SOF5-SOF7, DHP) JPEG.
A file cut short or corrupt raises ValueError (PIL raises OSError there).

Two halves:

  - entropy decoding (`_decode_scan`, sequential and progressive scans): a
    per-symbol Python loop over 16-bit lookahead tables that fills one flat
    int32 coefficient buffer a component (64 coefficients a block, zigzag
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
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xDE: "hierarchical JPEG (DHP)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCC: "arithmetic coding (DAC)",
    0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)",
    0xCF: "arithmetic coding (SOF15)",
}
# a marker after any fill bytes: every 0xFF not followed by a stuffed 0x00
_MARKER = re.compile(rb"\xff+([^\x00\xff])")

# jdcolor.c: FIX(x) in 16 fractional bits
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "bw", "bh", "coefs", "dw", "dh")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None     # latched at the component's first scan, as libjpeg does


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


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
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
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI marker")
    qtables: Dict[int, List[int]] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    frame = None           # (width, height, progressive)
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
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: corrupt data (two frames)")
            if len(body) < 6:
                raise ValueError("JPEG: corrupt frame header")
            precision, height, width, nc = body[0], (body[1] << 8) | body[2], \
                (body[3] << 8) | body[4], body[5]
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit precision is not decoded by the port")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG: {nc}-component files are not decoded by the port")
            if height == 0:
                raise ValueError("JPEG: a height defined by a DNL marker is not decoded "
                                 "by the port")
            if width == 0 or len(body) < 6 + 3 * nc:
                raise ValueError("JPEG: corrupt frame header")
            check_size("JPEG", width, height)
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
            frame = (width, height, marker == 0xC2)
        elif marker == 0xC4:
            i = 0
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
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or i + 1 + size > len(body):
                    raise ValueError("JPEG: corrupt quantisation table")
                raw = np.frombuffer(body, ">u2" if pq else np.uint8, 64, i + 1)
                qtables[tq] = raw.astype(np.int64).tolist()
                i += 1 + size
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
            pos = _sos(data, pos, body, comps, frame, qtables, dc_tabs, ac_tabs, restart)
    if frame is None:
        raise ValueError("JPEG: no frame")
    return _reconstruct(comps, frame, jfif, adobe)


def _sos(data, pos, body, comps, frame, qtables, dc_tabs, ac_tabs, restart) -> int:
    """One scan: its header, then its entropy-coded data. Returns the
    position of the marker after it."""
    width, height, progressive = frame
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise ValueError("JPEG: corrupt scan header")
    ids = {c.cid: i for i, c in enumerate(comps)}
    scan, dcl, acl = [], [None] * len(comps), [None] * len(comps)
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
            if c.tq not in qtables:
                raise ValueError("JPEG: corrupt data (quantisation table missing)")
            c.quant = qtables[c.tq]
        need_dc = not progressive or (ss == 0 and ah == 0)
        need_ac = not progressive or ss > 0
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
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    order, per_mcu = _scan_order(comps, scan, hmax, vmax, width, height)
    segments, end = _scan_segments(data, pos)
    _decode_scan(segments, order, per_mcu, restart, [c.coefs for c in comps], dcl, acl,
                 ss, se, ah, al, progressive)
    return end


def _reconstruct(comps: List[_Component], frame, jfif: bool, adobe: Optional[int]
                 ) -> np.ndarray:
    width, height, _ = frame
    if any(c.quant is None for c in comps):
        raise ValueError("JPEG: truncated (a component has no scan)")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = [_upsample(_plane(c), c, hmax, vmax, width, height) for c in comps]
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    if len(planes) == 4:
        return _cmyk_to_rgb(planes, adobe)
    # jdapimin.c default_decompress_parms: JFIF, then Adobe, then component ids
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66]
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


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
