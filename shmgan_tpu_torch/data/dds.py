"""DirectDraw Surface (DDS) as PIL 12's DdsImagePlugin reads it, to its
`convert("RGB")` pixels: the first surface (the largest mipmap).

    rgb = decode_dds(data)                    # (H, W, 3) uint8

The 124-byte header's pixel format decides, in PIL's order:

  - DDPF_RGB: each pixel `bits // 8` little-endian bytes, each channel
    int(((v & mask) >> shift) / (mask >> shift) * 255) as DdsRgbDecoder
    computes it, alpha dropped; a body cut short reads as zeros, as PIL
    reads it;
  - DDPF_LUMINANCE: 8-bit L, or 16-bit LA with DDPF_ALPHAPIXELS;
  - DDPF_PALETTEINDEXED8: 8-bit indices into a 256-entry RGBA palette;
  - DDPF_FOURCC: DXT1 (BC1), DXT3 (BC2), DXT5 (BC3), ATI1/BC4U (BC4),
    ATI2/BC5U (BC5) and BC5S, and a DX10 header's BC1-BC5 (BC5 signed
    too), BC6H (unsigned and signed) and BC7, and R8G8B8A8.

The block formats follow BcnDecode.c: 4x4 blocks row by row, cut at the
image's edges; BC1's 5:6:5 endpoints widened by bit replication, its
two inner colours (2a + b) / 3 and (a + 2b) / 3 in integers, or (a + b) /
2 and transparent black where the first endpoint is not the larger (BC2
and BC3 always take the four-colour mode); BC2's 4-bit alpha; the BC3/BC4
alpha ramps of 8 or 6 steps; BC5 two such channels (red, green) with blue
0, or, signed, each endpoint offset by 128 and blue 128; BC6H's 14 modes
and BC7's 8 (_bc6, _bc7), their partition and anchor tables and bit
layouts written from the published format and held bit for bit against
PIL on seeded random blocks (tests/test_torch_dds.py). Other pixel formats
are refused by name, as PIL refuses them; so is a block body or a raw
body cut short.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, check_size

_RGB, _LUMINANCE, _PALETTE, _FOURCC, _ALPHAPIXELS = 0x40, 0x20000, 0x20, 0x4, 0x1
# DXGI formats of a DX10 header -> PIL's block kind (n) and pixel format
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"), 76: (3, "BC3"),
         77: (3, "BC3"), 79: (4, "BC4"), 80: (4, "BC4"), 82: (5, "BC5"), 83: (5, "BC5"),
         84: (5, "BC5S"), 95: (6, "BC6H"), 96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"),
         99: (7, "BC7")}
_FOURCCS = {b"DXT1": (1, "DXT1"), b"DXT3": (2, "DXT3"), b"DXT5": (3, "DXT5"),
            b"BC4U": (4, "BC4"), b"ATI1": (4, "BC4"), b"BC5S": (5, "BC5S"),
            b"BC5U": (5, "BC5"), b"ATI2": (5, "BC5")}


def _rgb_masks(data: bytes, pos: int, w: int, h: int, bits: int, masks) -> np.ndarray:
    """DdsRgbDecoder: pixel k is the `bits // 8` bytes at pos + k * that,
    little-endian, zeros past the body's end. Its masks are 32-bit, so only
    a pixel's first four bytes are read."""
    nb, n = bits // 8, w * h
    v = np.zeros(n, np.int64)
    if nb:
        k = min(n, -(-max(0, len(data) - pos) // nb))     # pixels that read a byte
        src = np.frombuffer(data, np.uint8)
        for j in range(min(nb, 4)):
            at = pos + np.arange(k, dtype=np.int64) * nb + j
            v[:k] |= np.where(at < len(data), src[np.minimum(at, len(data) - 1)], 0
                              ).astype(np.int64) << (8 * j)
    out = []
    for mask in masks[:3]:
        if mask == 0:
            out.append(np.zeros(n, np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        out.append(((((v & mask) >> shift) / total) * 255).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, 3)


def _565(c: np.ndarray) -> np.ndarray:
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1_colours(blocks: np.ndarray, four: bool) -> np.ndarray:
    """(n, 8) BC1 colour blocks -> (n, 16, 3) int64."""
    c0 = blocks[:, 0].astype(np.int64) | blocks[:, 1].astype(np.int64) << 8
    c1 = blocks[:, 2].astype(np.int64) | blocks[:, 3].astype(np.int64) << 8
    p0, p1 = _565(c0), _565(c1)
    mode4 = ((c0 > c1) | four)[:, None]
    p2 = np.where(mode4, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(mode4, (p0 + 2 * p1) // 3, 0)
    table = np.stack([p0, p1, p2, p3], 1)                       # (n, 4, 3)
    lut = (blocks[:, 4].astype(np.int64) | blocks[:, 5].astype(np.int64) << 8
           | blocks[:, 6].astype(np.int64) << 16 | blocks[:, 7].astype(np.int64) << 24)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, idx[..., None], 1)


def _bc3_alpha(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 8) BC3/BC4 alpha blocks -> (n, 16) int64."""
    if signed:
        a0 = blocks[:, 0].view(np.int8).astype(np.int64) + 128
        a1 = blocks[:, 1].view(np.int8).astype(np.int64) + 128
    else:
        a0, a1 = blocks[:, 0].astype(np.int64), blocks[:, 1].astype(np.int64)
    a0, a1 = a0[:, None], a1[:, None]
    k = np.arange(1, 7)[None]
    eight = np.concatenate([a0, a1, ((7 - k) * a0 + k * a1) // 7], 1)
    k4 = np.arange(1, 5)[None]
    six = np.concatenate([a0, a1, ((5 - k4) * a0 + k4 * a1) // 5, np.zeros_like(a0),
                          np.full_like(a0, 255)], 1)
    table = np.where(a0 > a1, eight, six) & 0xFF
    bits = np.zeros(len(blocks), np.int64)
    for k in range(6):
        bits |= blocks[:, 2 + k].astype(np.int64) << (8 * k)
    idx = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(table, idx, 1)


# BC7/BC6H two-subset partitions: bit i is pixel i's subset
_PART2 = (
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
# BC7 three-subset partitions: bits 2i, 2i + 1 are pixel i's subset
_PART3 = (
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254)
# the second subset's anchor pixel, two subsets
_ANCHOR2 = (
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8,
    15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2,
    6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
# the second subset's anchor pixel, three subsets
_ANCHOR3A = (
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8,
    6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5,
    5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
# the third subset's anchor pixel, three subsets
_ANCHOR3B = (
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3,
    15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)


# BC7 modes: (subsets, partition bits, rotation bits, index-selection bits,
# colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
# second index bits)
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_WEIGHTS = {2: np.array([0, 21, 43, 64]), 3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}


class _Bits:
    """Little-endian bit fields of (n, 16) blocks, read in stream order."""

    def __init__(self, blocks: np.ndarray, pos: int):
        self.bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
        self.pos = pos

    def take(self, k: int) -> np.ndarray:
        v = np.zeros(len(self.bits), np.int64)
        for i in range(k):
            v |= self.bits[:, self.pos + i] << i
        self.pos += k
        return v

    def indices(self, k: int, anchors: np.ndarray, offs: np.ndarray):
        """16 indices of k bits, one bit fewer at each block's anchor pixels
        (anchors: (n, m)); -> (n, 16) indices, the offsets after them."""
        rows = np.arange(len(self.bits))
        idx = np.zeros((len(rows), 16), np.int64)
        for i in range(16):
            width = k - (anchors == i).any(1)
            for j in range(k):
                idx[:, i] |= np.where(j < width, self.bits[rows, np.minimum(offs + j, 127)],
                                      0) << j
            offs = offs + width
        return idx, offs


def _subsets(ns: int, part: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 16) subset of each pixel, (n, ns) anchor pixels."""
    n = len(part)
    if ns == 1:
        return np.zeros((n, 16), np.int64), np.zeros((n, 1), np.int64)
    if ns == 2:
        sub = (np.array(_PART2, np.int64)[part][:, None] >> np.arange(16)) & 1
        return sub, np.stack([np.zeros(n, np.int64), np.array(_ANCHOR2)[part]], 1)
    sub = (np.array(_PART3, np.int64)[part][:, None] >> (2 * np.arange(16))) & 3
    return sub, np.stack([np.zeros(n, np.int64), np.array(_ANCHOR3A)[part],
                          np.array(_ANCHOR3B)[part]], 1)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) BC7 blocks -> (n, 16, 3) RGB: the mode from the lowest set
    bit of the first byte (none: black), endpoints widened from their
    precision by replicating the top bits, ((64 - w) a + w b + 32) >> 6,
    modes 4 and 5's channel rotation and index selection."""
    out = np.zeros((len(blocks), 16, 3), np.int64)
    first = blocks[:, 0].astype(np.int64)
    mode_of = np.full(len(blocks), 8)
    for m in range(7, -1, -1):
        mode_of[(first >> m) & 1 == 1] = m
    for m, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(_BC7_MODES):
        sel = np.flatnonzero(mode_of == m)
        if not len(sel):
            continue
        f = _Bits(blocks[sel], m + 1)
        part, rot, swap = f.take(pb), f.take(rb), f.take(isb)
        ep = np.zeros((len(sel), 2 * ns, 4), np.int64)
        for c in range(3):
            for e in range(2 * ns):
                ep[:, e, c] = f.take(cb)
        for e in range(2 * ns):
            ep[:, e, 3] = f.take(ab)
        if epb or spb:                              # a p-bit below each endpoint
            for e in range(2 * ns if epb else ns):
                p = f.take(1)[:, None, None]
                span = slice(e, e + 1) if epb else slice(2 * e, 2 * e + 2)
                ep[:, span] = ep[:, span] << 1 | p
            cb, ab = cb + 1, ab + 1 if ab else 0
        ep[..., :3] <<= 8 - cb
        ep[..., :3] |= ep[..., :3] >> cb
        if ab:
            ep[..., 3] <<= 8 - ab
            ep[..., 3] |= ep[..., 3] >> ab
        else:
            ep[..., 3] = 255
        sub, anchors = _subsets(ns, part)
        idx, offs = f.indices(ib, anchors, np.full(len(sel), f.pos))
        wc = wa = _WEIGHTS[ib][idx]
        if ib2:
            idx2, _ = f.indices(ib2, anchors[:, :1], offs)
            w2 = _WEIGHTS[ib2][idx2]
            wc = np.where(swap[:, None] == 1, w2, wc)
            wa = np.where(swap[:, None] == 1, wa, w2)
        rows = np.arange(len(sel))[:, None]
        e0, e1 = ep[rows, 2 * sub], ep[rows, 2 * sub + 1]              # (n, 16, 4)
        w = np.concatenate([np.repeat(wc[..., None], 3, -1), wa[..., None]], -1)
        px = ((64 - w) * e0 + w * e1 + 32) >> 6
        for r in (1, 2, 3):                         # rotation: alpha swapped with r, g or b
            on = rot == r
            px[on, :, r - 1] = px[on, :, 3]
        out[sel] = px[..., :3]
    return out


# BC6H modes by the value of their mode bits (2 bits, or 5 where the low two
# are 10 or 11): (endpoint bits, delta bits (r, g, b) of the transformed
# modes, regions, the endpoint and partition bits in stream order: rw0-9 is
# bits 0 to 9 of the first endpoint's red, rw15-10 bits 15 down to 10; w, x
# the first region's endpoints, y, z the second's, d the partition)
_BC6_MODES = {
    0b00: (10, (5, 5, 5), 2, "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 "
                             "bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"),
    0b01: (7, (6, 6, 6), 2, "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 "
                            "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4"),
    0b00010: (11, (5, 4, 4), 2, "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 "
                                "bw10 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"),
    0b00110: (11, (4, 5, 4), 2, "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 "
                                "bw10 bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3 d0-4"),
    0b01010: (11, (4, 4, 5), 2, "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 "
                                "bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3 d0-4"),
    0b01110: (9, (5, 5, 5), 2, "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 "
                               "bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"),
    0b10010: (8, (6, 5, 5), 2, "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
                               "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5 d0-4"),
    0b10110: (8, (5, 6, 5), 2, "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 "
                               "gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"),
    0b11010: (8, (5, 5, 6), 2, "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 "
                               "bz0 gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"),
    0b11110: (6, None, 2, "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 "
                          "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4"),
    0b00011: (10, None, 1, "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9"),
    0b00111: (11, (9, 9, 9), 1, "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10"),
    0b01011: (12, (8, 8, 8), 1, "rw0-9 gw0-9 bw0-9 rx0-7 rw11 rw10 gx0-7 gw11 gw10 bx0-7 bw11 "
                                "bw10"),
    0b01111: (16, (4, 4, 4), 1, "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10"),
}
_BC6_ENDPOINTS = ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz")


def _bc6_layout(spec: str):
    """"rw0-9 rw15-10 bz4" -> [(field, bit), ...] in stream order."""
    out = []
    for tok in spec.split():
        k = len(tok.rstrip("0123456789-"))
        name, bits = tok[:k], tok[k:]
        a, b = (int(x) for x in bits.split("-")) if "-" in bits else (int(bits),) * 2
        out += [(name, i) for i in range(a, b + (1 if b >= a else -1), 1 if b >= a else -1)]
    return out


def _sext(v: np.ndarray, bits: int) -> np.ndarray:
    return np.where(v & (1 << (bits - 1)), v - (1 << bits), v)


def _bc6_unquantize(v: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << bits) - 1, 0xFFFF,
                                            ((v << 16) + 0x8000) >> bits))
    if bits >= 16:                                  # held as a signed 16-bit value
        return _sext(v & 0xFFFF, 16)
    a = np.abs(v)
    u = np.where(a == 0, 0, np.where(a >= (1 << (bits - 1)) - 1, 0x7FFF,
                                     ((a << 15) + 0x4000) >> (bits - 1)))
    return np.where(v < 0, -u, u)


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16) BC6H blocks -> (n, 16, 3) RGB as BcnDecode.c gives them: the
    first endpoint sign-extended in signed blocks, the transformed modes'
    deltas sign-extended and added modulo the endpoint's precision (and
    kept non-negative, as PIL keeps them, below 16 bits), unquantized,
    interpolated by (a (64 - w) + b w) >> 6, scaled by 31/64 (31/32 signed)
    to half floats, then clipped to [0, 1] and truncated to 8 bits. The
    reserved modes are black."""
    out = np.zeros((len(blocks), 16, 3), np.int64)
    low = blocks[:, 0].astype(np.int64)
    key = np.where(low & 3 < 2, low & 3, low & 31)
    for mode, (epb, delta, regions, layout) in _BC6_MODES.items():
        sel = np.flatnonzero(key == mode)
        if not len(sel):
            continue
        f = _Bits(blocks[sel], 2 if mode < 2 else 5)
        field = {k: np.zeros(len(sel), np.int64) for k in _BC6_ENDPOINTS + ("d",)}
        for name, bit in _bc6_layout(layout):
            field[name] |= f.bits[:, f.pos] << bit
            f.pos += 1
        nend = 2 * regions
        ep = np.stack([np.stack([field[k] for k in _BC6_ENDPOINTS[3 * e:3 * e + 3]], -1)
                       for e in range(nend)], 1)                      # (n, endpoint, rgb)
        if signed:
            ep[:, 0] = _sext(ep[:, 0], epb)
        if delta is not None:
            for c in range(3):
                ep[:, 1:, c] = (ep[:, :1, c] + _sext(ep[:, 1:, c], delta[c])) & ((1 << epb) - 1)
        elif signed:
            ep[:, 1:] = _sext(ep[:, 1:], epb)
        unq = _bc6_unquantize(ep, epb, signed)
        sub, anchors = _subsets(regions, field["d"])
        idx, _ = f.indices(3 if regions == 2 else 4, anchors, np.full(len(sel), f.pos))
        w = _WEIGHTS[3 if regions == 2 else 4][idx][..., None]
        rows = np.arange(len(sel))[:, None]
        v = (unq[rows, 2 * sub] * (64 - w) + unq[rows, 2 * sub + 1] * w) >> 6
        if signed:
            half = np.where(v < 0, 0x8000 | ((-v * 31) >> 5), (v * 31) >> 5)
        else:
            half = (v * 31) >> 6
        value = half.astype(np.uint16).view(np.float16).astype(np.float32)
        out[sel] = (np.clip(value, 0, 1) * np.float32(255)).astype(np.int64)
    return out


def _blocks(data: bytes, pos: int, w: int, h: int, size: int, kind: str) -> np.ndarray:
    bw, bh = (w + 3) // 4, (h + 3) // 4
    need = bw * bh * size
    if len(data) < pos + need:
        raise ValueError(f"DDS: truncated {kind} data")
    return np.frombuffer(data, np.uint8, count=need, offset=pos).reshape(bw * bh, size)


def _bcn(data: bytes, pos: int, w: int, h: int, n: int, fmt: str) -> np.ndarray:
    blocks = _blocks(data, pos, w, h, 8 if n in (1, 4) else 16, fmt)
    if n == 1:
        px = _bc1_colours(blocks, False)
    elif n in (2, 3):
        px = _bc1_colours(blocks[:, 8:], True)
    elif n == 4:
        px = np.repeat(_bc3_alpha(blocks)[..., None], 3, -1)
    elif n == 6:
        px = _bc6(blocks, fmt == "BC6HS")
    elif n == 7:
        px = _bc7(blocks)
    else:
        signed = fmt == "BC5S"
        px = np.stack([_bc3_alpha(blocks[:, :8], signed), _bc3_alpha(blocks[:, 8:], signed),
                       np.full((len(blocks), 16), 128 if signed else 0)], -1)
    bw, bh = (w + 3) // 4, (h + 3) // 4
    img = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 3)
    return np.ascontiguousarray(img[:h, :w].astype(np.uint8))


def decode_dds(data: bytes) -> np.ndarray:
    if len(data) < 8:
        raise NotThisFormat("DDS: truncated header")
    (hsize,) = struct.unpack("<I", data[4:8])
    if hsize != 124:
        raise ValueError(f"DDS: header size {hsize}, not the 124 PIL reads")
    if len(data) < 128:
        raise ValueError("DDS: truncated header")
    h, w = struct.unpack("<II", data[12:20])
    pf_flags, fourcc, bits = struct.unpack("<I4sI", data[80:92])
    pos = 128
    if w == 0 or h == 0:
        raise NotThisFormat("DDS: empty image")
    if pf_flags & _RGB:
        masks = struct.unpack("<4I", data[92:108])[:4 if pf_flags & _ALPHAPIXELS else 3]
        check_size("DDS", w, h)
        return _rgb_masks(data, pos, w, h, bits, masks)
    if pf_flags & _LUMINANCE:
        if bits == 8:
            bands = 1
        elif bits == 16 and pf_flags & _ALPHAPIXELS:
            bands = 2
        else:
            raise ValueError(f"DDS: luminance of {bits} bits, which PIL does not read")
        palette = None
    elif pf_flags & _PALETTE:
        raw = data[pos:pos + 1024]
        pos += len(raw)
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(raw[:len(raw) // 4 * 4], np.uint8).reshape(-1, 4)[:, :3]
        palette[:len(entries)] = entries
        bands = 1
    elif pf_flags & _FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise ValueError("DDS: truncated DX10 header")
            (dxgi,) = struct.unpack("<I", data[128:132])
            pos = 148
            if dxgi in (27, 28, 29):            # R8G8B8A8: raw RGBA
                palette, bands = None, 4
            elif dxgi in _DXGI:
                check_size("DDS", w, h)
                return _bcn(data, pos, w, h, *_DXGI[dxgi])
            else:
                raise ValueError(f"DDS: DXGI format {dxgi}, which PIL does not read")
        elif fourcc in _FOURCCS:
            check_size("DDS", w, h)
            return _bcn(data, pos, w, h, *_FOURCCS[fourcc])
        else:
            raise ValueError(f"DDS: pixel format {fourcc!r}, which PIL does not read")
    else:
        raise ValueError(f"DDS: pixel format flags {pf_flags:#x}, which PIL does not read")
    check_size("DDS", w, h)
    if len(data) < pos + w * h * bands:
        raise ValueError("DDS: truncated image data")
    px = np.frombuffer(data, np.uint8, count=w * h * bands, offset=pos).reshape(h, w, bands)
    if palette is not None:
        return palette[px[..., 0]]
    if bands == 4:
        return np.ascontiguousarray(px[..., :3])
    return np.repeat(px[..., :1], 3, -1)
