"""TIFF decoding in numpy and the standard library: what the JAX package gets
from PIL's `Image.open(...).convert("RGB")` (TiffImagePlugin, with libtiff
for every compressed file), pixel for pixel.

    rgb = decode_tiff(data)     # (H, W, 3) uint8

Read: the first IFD only, as PIL opens it; byte order II and MM, classic
TIFF and BigTIFF; strips and tiles; planar configuration 1 (chunky) and 2
(one plane a sample); compression none (1), PackBits (32773), LZW (5, the
early-change codes every writer since TIFF 6.0 uses), Deflate (8, 32946),
LZMA (34925, Python's lzma module; refused by name where it is missing),
Zstd (50000, data/zstd.py), JPEG (7, each strip or tile a JPEG stream
after the JPEGTables tag's tables, data/jpeg.py) and the CCITT fax codes:
Modified Huffman (2), T.4 one- and two-dimensional (3, T4Options) and T.6
(4) (data/ccitt.py); the horizontal predictor (2) at 8, 16 and 32 bits and
the floating-point predictor (3) with LZW, Deflate, LZMA and Zstd (libtiff
reads the tag for no other code); FillOrder 2 (bits reversed in each byte,
undone before decompression) where PIL reads it.

Photometric interpretations, as PIL's OPEN_INFO maps them and `convert`
then turns them to RGB:

  - min-is-white (0) and min-is-black (1) at 1, 2, 4 and 8 bits, min-is-white
    inverted (PIL's "1;I", "L;2I", "L;4I", "L;I"), 2 and 4 bits scaled by 85
    and 17; 12 bits (PIL's I;12, little-endian min-is-black) and 16 bits
    (I;16 and I;16B, min-is-white little-endian only, and not inverted, as
    PIL reads it), clipped at 255; grey + alpha (LA);
  - sample formats: 32-bit float (F; clipped to 0..255, then truncated, NaN
    0; min-is-white not inverted), signed 16 and 32 bits and unsigned 32
    bits (little-endian only) as PIL's I, clipped; signed 8 bits read as
    unsigned; big-endian 32-bit and signed 16-bit samples through libtiff
    byte-swapped, as PIL unpacks libtiff's host-order samples;
  - RGB at 8 and 16 bits (16: the high byte), with extra samples dropped:
    unassociated or unspecified alpha as stored, associated alpha
    (ExtraSamples 1, PIL's "RGBa") divided out first, v * 255 // a, zero
    where a is zero;
  - palette (3) at 1, 2, 4 and 8 bits, the ColorMap's 16-bit entries // 256;
  - separated CMYK (5) at 8 and 16 bits (16: the high byte), through PIL's
    cmyk2rgb;
  - YCbCr (6): JPEG-compressed, converted by libjpeg (PIL sets
    JPEGCOLORMODE_RGB: fancy upsampling, jdcolor's tables); otherwise
    through libtiff's RGBA interface, which PIL uses for it: subsampling
    1, 2 or 4 across by 1, 2 or 4 down (as libtiff lists them), each block's
    chroma replicated, libtiff's fixed-point tables from YCbCrCoefficients
    and ReferenceBlackWhite, and its short read of a strip whose block row
    does not divide by the vertical subsampling;
  - CIELab (8), through PIL's LAB -> RGB, which is LittleCMS's
    (lab_to_rgb).

The Orientation tag is applied (TiffImagePlugin's load_end calls
ImageOps.exif_transpose). Refused with a ValueError that names the
variant: old-style JPEG-in-TIFF (6), ThunderScan, SGILog and raw 16-bit
words (which PIL's libtiff reads), WebP (which it does not), CCITT
uncompressed mode, uncompressed YCbCr and the YCbCr layouts libtiff's RGBA
interface has no case for (PIL refuses them too), JPEG-in-TIFF of other
than 8-bit chunky grey, RGB, YCbCr, CMYK or CIELab, a Zstd frame that needs
a dictionary; and any layout PIL refuses ("unknown pixel mode", saying so).
A file cut short or corrupt raises ValueError.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

_COMPRESSION_REFUSED = {
    6: "old-style JPEG-in-TIFF (compression 6)",
    32771: "raw 16-bit words (compression 32771)",
    32809: "ThunderScan (compression 32809)", 34676: "SGILog (compression 34676)",
    34677: "SGILog24 (compression 34677)", 50001: "WebP (compression 50001)",
}
_JPEG, _LZMA, _ZSTD, _FAX = 7, 34925, 50000, (2, 3, 4)
# the codes whose strips libtiff bit-reverses for FillOrder 2 (the fax codes
# read their bits in fill order themselves, to the same effect)
_BITREV_CODECS = (1, 32773, 5, 8, 32946, _LZMA, _ZSTD) + _FAX
# tag -> name of the tags the decoder reads
_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTO, _FILL = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _ORIENTATION, _SPP, _ROWS, _STRIP_COUNTS = 273, 274, 277, 278, 279
_PLANAR, _PREDICTOR, _COLORMAP, _TILE_W, _TILE_H = 284, 317, 320, 322, 323
_TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _FORMAT = 324, 325, 338, 339
_JPEG_TABLES, _YCC_COEFFS, _YCC_SUB, _REF_BW = 347, 529, 530, 532
_T4_OPTIONS = 292
# TIFF field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_BIT_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the first IFD's integer-valued tags (tag ->
    tuple of values)."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:
            size, zero, offset = struct.unpack_from(bo + "HHQ", data, 4)
            if size != 8 or zero != 0:
                raise ValueError("TIFF: corrupt BigTIFF header")
            (n,) = struct.unpack_from(bo + "Q", data, offset)
            entry, pos, inline, count_fmt = 20, offset + 8, 8, "Q"
        else:
            (offset,) = struct.unpack_from(bo + "I", data, 4)
            (n,) = struct.unpack_from(bo + "H", data, offset)
            entry, pos, inline, count_fmt = 12, offset + 2, 4, "I"
    except struct.error:
        raise ValueError("TIFF: truncated header") from None
    if n > 4096 or pos + n * entry > len(data):
        raise ValueError("TIFF: truncated or corrupt IFD")
    tags = {}
    for i in range(n):
        at = pos + i * entry
        tag, kind, count = struct.unpack_from(bo + "HH" + count_fmt, data, at)
        if kind not in _TYPES:
            continue                        # PIL skips fields of unknown type too
        code, size = _TYPES[kind]
        nbytes = count * size
        value_at = at + 4 + (8 if big else 4)
        if nbytes > inline:
            (value_at,) = struct.unpack_from(bo + count_fmt, data, value_at)
        if value_at + nbytes > len(data):
            raise ValueError(f"TIFF: tag {tag} points past the end of the file")
        if kind in (5, 10):                 # rationals, as libtiff reads them: float
            pairs = struct.unpack_from(bo + code * count, data, value_at)
            tags[tag] = tuple(float(np.float32(a / b)) if b else 0.0
                              for a, b in zip(pairs[::2], pairs[1::2]))
            continue
        if kind in (2, 11, 12):             # text, floats: not read here
            tags[tag] = ()
            continue
        tags[tag] = struct.unpack_from(bo + code * count, data, value_at) if count else ()
    return bo, tags


def _one(tags, tag, default):
    v = tags.get(tag)
    return v[0] if v else default


def _packbits(src: bytes, need: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < need:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += src[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _lzw(src: bytes, need: int) -> bytes:
    """TIFF LZW (libtiff's LZWDecode): codes most significant bit first,
    9 to 12 bits wide, one bit wider as soon as the next free code is the
    last of the current width (the early change); 256 clears, 257 ends."""
    if src[:2] == b"\x00\x01":
        raise ValueError("TIFF: old-style (pre-6.0) LZW is not decoded by the port")
    words = src + bytes(4)
    nbits_total = 8 * len(src)
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, pos, prev = 9, 0, None
    while pos + width <= nbits_total and len(out) < need:
        byte = pos >> 3
        word = (words[byte] << 16) | (words[byte + 1] << 8) | words[byte + 2]
        code = (word >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError("TIFF: corrupt LZW data")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(table[prev] + entry[:1])
            elif code == len(table):
                entry = table[prev] + table[prev][:1]
                table.append(entry)
            else:
                raise ValueError("TIFF: corrupt LZW data")
            if len(table) == (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = code
    return bytes(out)


def _inflate(src: bytes, need: int) -> bytes:
    d = zlib.decompressobj()
    try:
        return d.decompress(src, need)
    except zlib.error as e:
        raise ValueError(f"TIFF: corrupt Deflate data ({e})") from None


_DECOMPRESS = {1: lambda src, need: src[:need], 32773: _packbits, 5: _lzw,
               8: _inflate, 32946: _inflate}


def _mode(bo: str, photo: int, fmt: tuple, fill: int, bps: tuple, extra: tuple) -> str:
    """PIL's OPEN_INFO key -> the port's name for the layout; ValueError
    for what PIL refuses or the port does not read."""
    n = len(bps)
    if fill not in (1, 2):
        raise ValueError(f"TIFF: FillOrder {fill} is refused by PIL too")
    if fmt == (3,) and photo in (0, 1) and bps == (32,) and extra == () and fill == 1:
        return "float"                              # PIL's F;32F, F;32BF
    if fmt == (2,) and photo == 1 and extra == () and fill == 1:
        if bps == (8,):
            return "grey"                           # PIL reads it as unsigned L
        if bps in ((16,), (32,)):
            return "int"                            # I;16S, I;32S and their MM forms
    if fmt != (1,):
        raise ValueError(f"TIFF: SampleFormat {fmt} at {bps} bits, photometric {photo}, is "
                         "refused by PIL too (unknown pixel mode)")
    if photo in (0, 1) and n == 1 and extra == ():
        b = bps[0]
        if b in (1, 2, 4, 8):
            return "grey"
        if b == 16 and (bo == "<" and (photo == 1 or fill == 1) or photo == 1 and fill == 1):
            return "grey16"
        if bo == "<" and photo == 1 and fill == 1 and b in (12, 32):
            return "grey12" if b == 12 else "int"  # I;12 and I;32N (read as signed)
    if photo == 1 and bps == (8, 8) and extra == (2,) and fill == 1:
        return "grey_alpha"
    if photo == 2 and fill in (1, 2) and bps == (8, 8, 8) and extra == ():
        return "rgb"
    if photo == 2 and fill == 1:
        if all(b == 8 for b in bps) and n >= 4 and (
                (n == 4 and extra in ((), (0,), (1,), (2,), (999,)))
                or (n == 5 and extra in ((0, 0), (1, 0), (2, 0)))
                or (n == 6 and extra in ((0, 0, 0), (1, 0, 0), (2, 0, 0)))):
            return "rgb_premultiplied" if extra[:1] == (1,) else "rgb"
        if bps == (16, 16, 16) and extra == () or bps == (16,) * 4 and extra in (
                (), (0,), (2,)):
            return "rgb"
        if bps == (16,) * 4 and extra == (1,):
            return "rgb_premultiplied"
    if photo == 3 and extra == () and n == 1 and bps[0] in (1, 2, 4, 8):
        return "palette"
    if photo == 3 and fill == 1 and bps == (8, 8) and extra in ((0,), (2,)):
        return "palette"
    if photo == 5 and fill == 1 and (
            bps == (8,) * 4 and extra == () or bps == (8,) * 5 and extra == (0,)
            or bps == (8,) * 6 and extra == (0, 0) or bps == (16,) * 4 and extra == ()):
        return "cmyk"
    if photo == 6 and fill == 1 and extra == () and bps in ((8,), (8, 8, 8)):
        return "grey" if n == 1 else "ycbcr"
    if photo == 8 and fill == 1 and extra == () and bps == (8, 8, 8):
        return "lab"
    if photo == 4:
        raise ValueError("TIFF: transparency-mask photometric (4) is refused by PIL too "
                         "(unknown pixel mode)")
    raise ValueError(f"TIFF: the layout photometric {photo}, {bps} bits, extra samples "
                     f"{extra}, FillOrder {fill} is refused by PIL too (unknown pixel mode)")


def _unpredict(rows: np.ndarray, spp: int, bits: int, bo: str) -> np.ndarray:
    """Undo the horizontal predictor on (rows, row bytes) uint8: each sample
    the sum of the differences to its left, modulo 2 ** bits."""
    h = rows.shape[0]
    if bits == 8:
        return np.cumsum(rows.reshape(h, -1, spp), axis=1, dtype=np.uint8).reshape(h, -1)
    u = {16: np.uint16, 32: np.uint32}[bits]
    s = rows.copy().view(f"{bo}u{bits // 8}").reshape(h, -1, spp)
    s = np.cumsum(s, axis=1, dtype=u)
    return s.astype(f"{bo}u{bits // 8}").view(np.uint8).reshape(h, -1)


def _samples(rows: np.ndarray, w: int, spp: int, bits: int, bo: str, mode: str) -> np.ndarray:
    """(h, row bytes) uint8 -> (h, w, spp) samples: uint8 at up to 8 bits
    (packed depths unpacked, most significant first), uint16 at 12 and 16
    (int16 for signed samples), int32 or float32 at 32."""
    h = rows.shape[0]
    if bits in (16, 32):
        kind = {"float": "f", "int": "i"}.get(mode, "u")
        native = _DTYPES.get((mode, bits), np.uint16)
        return rows[:, :bits // 8 * w * spp].copy().view(f"{bo}{kind}{bits // 8}").astype(
            native).reshape(h, w, spp)
    if bits == 12:                      # PIL's I;12: two samples in three bytes
        n = w * spp
        b = rows[:, :3 * (-(-n // 2))].astype(np.uint16)
        b = np.pad(b, ((0, 0), (0, (-b.shape[1]) % 3))).reshape(h, -1, 3)
        pair = np.stack([(b[..., 0] << 4) | (b[..., 1] >> 4),
                         ((b[..., 1] & 15) << 8) | b[..., 2]], -1).reshape(h, -1)
        return pair[:, :n].reshape(h, w, spp)
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)
    return rows[:, :w * spp].reshape(h, w, spp)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 RGB."""
    data = bytes(data)
    if data[:4] not in TIFF_SIGNATURES:
        raise ValueError("TIFF: no TIFF header")
    if data[:4] == b"MM\x00+":
        raise ValueError("TIFF: big-endian BigTIFF is refused by PIL too (it reads the header "
                         "as classic TIFF)")
    bo, tags = _ifd(data)
    w, h = _one(tags, _WIDTH, None), _one(tags, _LENGTH, None)
    if w is None or h is None:
        raise ValueError("TIFF: missing dimensions")
    check_size("TIFF", w, h)
    if w <= 0 or h <= 0:
        raise ValueError("TIFF: empty image")
    compression = _one(tags, _COMPRESSION, 1)
    if compression in _COMPRESSION_REFUSED:
        raise ValueError(f"TIFF: {_COMPRESSION_REFUSED[compression]} is not decoded by the port")
    if compression not in _DECOMPRESS and compression not in (_JPEG, _LZMA, _ZSTD) + _FAX:
        raise ValueError(f"TIFF: compression {compression} is refused by PIL too")
    photo = _one(tags, _PHOTO, 0)
    planar = _one(tags, _PLANAR, 1)
    fill = _one(tags, _FILL, 1)
    fmt = tuple(tags.get(_FORMAT, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(tags.get(_BPS, (1,)))
    extra = tuple(tags.get(_EXTRA, ()))
    spp = _one(tags, _SPP, 1)
    if spp > 6:
        raise ValueError(f"TIFF: {spp} samples a pixel is refused by PIL too")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: BitsPerSample does not match SamplesPerPixel")
    mode = _mode(bo, photo, fmt, fill, bps, extra)
    bits = bps[0]
    if planar not in (1, 2):
        raise ValueError(f"TIFF: planar configuration {planar} is refused by PIL too")
    if planar == 2 and extra[:1] in ((0,), (1,)) and (
            compression == 1 or extra[0] == 0 and _TILE_OFFSETS not in tags):
        raise ValueError(f"TIFF: {'uncompressed' if compression == 1 else 'striped'} planar "
                         f"samples with extra sample {extra[0]} are refused by PIL too")
    if fill == 2 and compression not in _BITREV_CODECS:
        raise ValueError(f"TIFF: FillOrder 2 with compression {compression} is not decoded by "
                         "the port")
    if fill == 2 and (compression == 32773 and bits == 1
                      or compression == 1 and (mode == "palette" and bits < 8
                                               or mode == "grey" and photo == 0 and bits == 8)):
        raise ValueError(f"TIFF: FillOrder 2 with compression {compression} at {bits} bits "
                         f"({mode}) is refused by PIL too")
    if planar == 2 and bits == 16 and compression == 1:
        raise ValueError("TIFF: uncompressed 16-bit planar samples (which PIL unpacks as 8-bit "
                         "planes) are not decoded by the port")
    if planar == 2 and bits in (12, 32) and compression == 1:
        raise ValueError(f"TIFF: uncompressed {bits}-bit planar samples are not decoded by "
                         "the port")
    sub = (1, 1)
    if mode == "ycbcr":
        sub = tuple(tags.get(_YCC_SUB, (2, 2)))[:2]
        if compression == 1:
            raise ValueError("TIFF: uncompressed YCbCr is refused by PIL too (it unpacks "
                             "4 bytes a pixel: 'image file is truncated')")
        if planar == 2 and (compression == _JPEG or sub != (1, 1)):
            raise ValueError("TIFF: planar YCbCr other than uncompressed-layout 1x1 is not "
                             "decoded by the port")
        if compression != _JPEG and sub not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                                 (4, 2), (4, 4)):
            raise ValueError(f"TIFF: YCbCr subsampling {sub} is refused by PIL too "
                             "(libtiff's RGBA interface has no such case)")
    elif mode == "grey" and photo == 6 and compression not in (1, _JPEG):
        raise ValueError("TIFF: one-sample YCbCr through libtiff is refused by PIL too")
    if compression == _JPEG:
        if bits != 8 or mode not in ("grey", "rgb", "cmyk", "ycbcr", "lab") or planar != 1 \
                or fmt != (1,) or extra != ():
            raise ValueError(f"TIFF: JPEG-in-TIFF at {bits} bits, photometric {photo}, "
                             f"planar {planar}, is not decoded by the port")
    if compression in _FAX and (bps != (1,) or photo not in (0, 1) or planar != 1):
        raise ValueError(f"TIFF: CCITT data of {bps} bits, photometric {photo}, is refused by "
                         "libtiff too (Group 3/4 codes are 1 bit a pixel)")
    # libtiff reads the Predictor tag for LZW, Deflate, LZMA and Zstd only
    predictor = _one(tags, _PREDICTOR, 1) if compression in (5, 8, 32946, _LZMA, _ZSTD) else 1
    if predictor not in (1, 2, 3):
        raise ValueError(f"TIFF: predictor {predictor} is refused by libtiff too")
    if predictor == 2 and bits not in (8, 16, 32):
        raise ValueError(f"TIFF: the horizontal predictor at {bits} bits is refused by "
                         "libtiff too")
    if predictor == 3 and mode != "float":
        raise ValueError("TIFF: the floating-point predictor (3) on integer samples is "
                         "refused by libtiff too")
    if predictor == 2 and mode == "ycbcr" and sub != (1, 1):
        raise ValueError("TIFF: the horizontal predictor on subsampled YCbCr is not decoded "
                         "by the port")
    tables = bytes(tags.get(_JPEG_TABLES, ())) if compression == _JPEG else b""

    if _TILE_OFFSETS in tags:
        tw, th = _one(tags, _TILE_W, 0), _one(tags, _TILE_H, 0)
        if tw <= 0 or th <= 0 or tw % 16 or th % 16:
            raise ValueError(f"TIFF: bad tile size {tw}x{th}")
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
        grid = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    elif _STRIP_OFFSETS in tags:
        tw, th = w, min(max(_one(tags, _ROWS, h), 1), h)
        offsets, counts = tags[_STRIP_OFFSETS], tags.get(_STRIP_COUNTS)
        grid = [(0, y) for y in range(0, h, th)]
    else:
        raise ValueError("TIFF: no strips or tiles")
    planes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    if len(offsets) < len(grid) * planes:
        raise ValueError("TIFF: fewer strip or tile offsets than the image needs")
    if counts is None or len(counts) < len(offsets):
        if compression != 1:
            raise ValueError("TIFF: compressed data without byte counts")
        counts = [len(data)] * len(offsets)
    # the chunk decoder turns YCbCr to RGB (libjpeg, or libtiff's RGBA interface)
    out_spp, out_mode = chunk_spp, mode
    if mode == "ycbcr":
        out_spp, out_mode = (3 if planar == 1 else 1), "rgb"
    out = np.zeros((planes, h, w, out_spp), _DTYPES.get((mode, bits), np.uint8))
    for plane in range(planes):
        for i, (x0, y0) in enumerate(grid):
            k = plane * len(grid) + i
            rows_here = th if _TILE_OFFSETS in tags else min(th, h - y0)
            src = data[offsets[k]:offsets[k] + counts[k]]
            if compression == _JPEG:
                px = _jpeg_chunk(src, tables, tw, rows_here, th, mode)
            else:
                px = _raw_chunk(src, compression, fill, tw, rows_here, chunk_spp, bits, bo,
                                predictor, mode, sub, tags, _TILE_OFFSETS not in tags)
            ch, cw = min(th, h - y0), min(tw, w - x0)
            out[plane, y0:y0 + ch, x0:x0 + cw] = px[:ch, :cw]
    px = np.concatenate(list(out), axis=-1) if planes > 1 else out[0]
    if mode == "ycbcr" and planar == 2:
        px = _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], tags)
    if mode in ("float", "int") and bo == ">" and compression != 1:
        # libtiff hands PIL the samples in the host's (little-endian) order,
        # which PIL's F;32BF, I;32BS and I;16BS unpack as big-endian
        px = px.byteswap()
    rgb = _to_rgb(px, out_mode, photo, bits, tags)
    return _orient(rgb, _one(tags, _ORIENTATION, 1))


# (mode, bits) -> the dtype of the decoded samples, where not uint8
_DTYPES = {("grey16", 16): np.uint16, ("rgb", 16): np.uint16, ("rgb_premultiplied", 16): np.uint16,
           ("cmyk", 16): np.uint16, ("grey12", 12): np.uint16, ("float", 32): np.float32,
           ("int", 16): np.int16, ("int", 32): np.int32}


def _raw_chunk(src, compression, fill, tw, rows, spp, bits, bo, predictor, mode, sub, tags,
               strip):
    """One strip or tile of a compression other than JPEG -> its samples
    (rows, tw, spp); subsampled YCbCr -> RGB (rows, tw, 3)."""
    if mode == "ycbcr" and spp == 3 and sub != (1, 1):
        hs, vs = sub
        bw, bh = -(-tw // hs), -(-rows // vs)
        need = bw * bh * (hs * vs + 2)
    else:
        row_bytes = (tw * spp * bits + 7) // 8
        need = rows * row_bytes
    if fill == 2:                   # libtiff reverses the bits before decompressing
        src = src.translate(_BIT_REVERSE)
    if compression in _FAX:
        from shmgan_tpu_torch.data.ccitt import decode_fax
        return decode_fax(src, tw, rows, compression, _one(tags, _T4_OPTIONS, 0))[..., None]
    if compression == _ZSTD:
        from shmgan_tpu_torch.data.zstd import zstd_decompress
        raw = zstd_decompress(src, need)
    elif compression == _LZMA:
        raw = _lzma(src, need)
    else:
        raw = _DECOMPRESS[compression](src, need)
    if len(raw) < need:
        raise ValueError("TIFF: truncated strip or tile data")
    if mode == "ycbcr" and spp == 3 and sub != (1, 1):
        if strip:
            # libtiff's gtStripContig reads whole block rows of its scanline
            # size, a block row's bytes // v: where that division has a
            # remainder it reads short, and the rest of its (zeroed) buffer
            # stands in for the last blocks' samples
            read = bh * vs * (bw * (hs * vs + 2) // vs)
            raw = raw[:read] + bytes(need - read)
        blocks = np.frombuffer(raw, np.uint8, count=need).reshape(bh, bw, hs * vs + 2)
        y = blocks[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3)
        y = y.reshape(bh * vs, bw * hs)
        cb = np.repeat(np.repeat(blocks[..., -2], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(blocks[..., -1], vs, 0), hs, 1)
        return _ycbcr_to_rgb(y, cb, cr, tags)[:rows, :tw]
    rows_ = np.frombuffer(raw, np.uint8, count=need).reshape(rows, row_bytes)
    if predictor == 2:
        rows_ = _unpredict(rows_, spp, bits, bo)
    elif predictor == 3:
        rows_ = _unpredict_float(rows_, spp, bits, bo)
    px = _samples(rows_, tw, spp, bits, bo, mode)
    if mode == "ycbcr" and spp == 3:
        return _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], tags)
    return px


def _jpeg_chunk(src, tables, tw, rows, th, mode):
    """One strip or tile of JPEG-in-TIFF -> (rows, tw, spp) samples, as
    libtiff's JPEG codec has libjpeg give them: YCbCr converted to RGB
    (PIL sets JPEGCOLORMODE_RGB), every other photometric as coded (an
    unknown colour space). Both upsample as libjpeg does. libtiff refuses
    a frame past the strip or tile (a last strip's may keep the full strip
    height)."""
    from shmgan_tpu_torch.data.jpeg import jpeg_planes, ycc_to_rgb

    planes = jpeg_planes(src, tables, limit=(tw, th))
    want = {"grey": 1, "rgb": 3, "ycbcr": 3, "lab": 3, "cmyk": 4}[mode]
    if len(planes) != want:
        raise ValueError(f"TIFF: a JPEG strip or tile of {len(planes)} components where "
                         f"the photometric needs {want}")
    ph, pw = planes[0].shape
    if ph < rows or pw < tw:
        raise ValueError(f"TIFF: a JPEG strip or tile of {pw}x{ph} where {tw}x{rows} is "
                         "needed")
    if mode == "ycbcr":
        return ycc_to_rgb(*planes)[:rows, :tw]
    return np.stack(planes, -1)[:rows, :tw].astype(np.uint8)


def _lzma(src: bytes, need: int) -> bytes:
    try:
        import lzma
    except ImportError:
        raise ValueError("TIFF: LZMA (compression 34925) needs Python's lzma module, which "
                         "this Python lacks") from None
    try:
        return lzma.LZMADecompressor().decompress(src, need)
    except lzma.LZMAError as e:
        raise ValueError(f"TIFF: corrupt LZMA data ({e})") from None



def _unpredict_float(rows: np.ndarray, spp: int, bits: int, bo: str) -> np.ndarray:
    """libtiff's floating-point predictor (3): each row's bytes summed
    along the row (a stride of spp bytes), then regrouped from byte planes
    (most significant first) into samples in the file's byte order."""
    h = rows.shape[0]
    nb = bits // 8
    acc = np.cumsum(rows.reshape(h, -1, spp), axis=1, dtype=np.uint8).reshape(h, -1)
    planes_ = acc.reshape(h, nb, -1)                       # byte planes, MSB first
    be = planes_.transpose(0, 2, 1)                        # (h, samples, bytes) big-endian
    if bo == "<":
        be = be[..., ::-1]
    return np.ascontiguousarray(be).reshape(h, -1)


def _ycbcr_to_rgb(y, cb, cr, tags) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB (tif_color.c), which
    PIL reaches through TIFFReadRGBA*: tables in 16-bit fixed point from
    the YCbCrCoefficients and ReferenceBlackWhite tags (their defaults
    0.299, 0.587, 0.114 and 0, 255, 128, 255, 128, 255), in float32 as
    libtiff computes them. The chroma of a subsampled block is replicated
    (no interpolation), which the caller has done."""
    f32 = np.float32
    luma = [f32(v) for v in (tags.get(_YCC_COEFFS) or (0.299, 0.587, 0.114))[:3]]
    ref = [f32(v) for v in (tags.get(_REF_BW) or (0, 255, 128, 255, 128, 255))[:6]]
    if len(luma) < 3 or len(ref) < 6 or abs(luma[1]) < np.finfo(f32).eps or any(
            np.isnan(luma)) or any(np.isnan(ref)):
        raise ValueError("TIFF: invalid YCbCrCoefficients or ReferenceBlackWhite, refused by "
                         "libtiff too")

    def fix(x):                     # FIX(x): (int32_t)(x * 65536.0f + 0.5)
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clampf(x):
        return min(max(x, f32(0)), f32(2))
    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2, d3, d4 = fix(clampf(f1)), -fix(clampf(f2)), fix(clampf(f3)), -fix(clampf(f4))
    x = np.arange(-128, 128)

    def code2v(c, rb, rw, cr):      # Code2V, then CLAMPw to +-4096 and (int32_t)
        den = rw - rb if rw - rb != 0 else f32(1)
        v = (c - int(rb)).astype(f32) * f32(cr) / f32(den)
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)
    c_r = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    c_b = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    cr_r = (d1 * c_r + 32768) >> 16
    cb_b = (d3 * c_b + 32768) >> 16
    cr_g = d2 * c_r
    cb_g = d4 * c_b + 32768
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    yy = y_tab[y.astype(np.int64)]
    cb, cr = cb.astype(np.int64), cr.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _lab_clut() -> np.ndarray:
    """LittleCMS's 16-bit CLUT for PIL's LAB -> RGB transform (ImageCms,
    a Lab v2 profile to its built-in sRGB, perceptual intent): the float
    pipeline (Lab D50 -> XYZ -> the Bradford-adapted sRGB matrix -> the
    sRGB curve's inverse), each stage's output rounded to float32 as
    LittleCMS's stages round it, sampled on 33 nodes an axis
    (_cmsQuantizeVal) and saturated to 16 bits. (33, 33, 33, 3) int64."""
    f32, adj = np.float32, 1 + 32767 / 32768          # MAX_ENCODEABLE_XYZ
    xy = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]])
    w65 = np.array([0.3127 / 0.3290, 1.0, (1 - 0.3127 - 0.3290) / 0.3290])
    prim = np.stack([xy[:, 0] / xy[:, 1], np.ones(3), (1 - xy.sum(1)) / xy[:, 1]])
    rgb2xyz = prim * np.linalg.solve(prim, w65)[None]
    brad = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                     [0.0389, -0.0685, 1.0296]])
    d50 = np.array([0.9642, 1.0, 0.8249])
    adapt = np.linalg.inv(brad) @ np.diag((brad @ d50) / (brad @ w65)) @ brad
    inv = np.linalg.inv(adapt @ rgb2xyz) * adj
    q = np.floor(np.arange(33) * 65535 / 32 + 0.5)
    ql, qa, qb = np.meshgrid(q, q, q, indexing="ij")
    lab = [(x.astype(f32) / f32(65535)).astype(np.float64) for x in (ql, qa, qb)]
    fy = (lab[0] * 100.0 + 16) / 116
    f = [fy + (lab[1] * 255.0 - 128.0) / 500, fy, fy - (lab[2] * 255.0 - 128.0) / 200]
    xyz = [(white * np.where(t <= 24 / 116, 108 / 841 * (t - 16 / 116), t ** 3) / adj
            ).astype(f32).astype(np.float64) for white, t in zip(d50, f)]
    lin = np.stack([(inv[i, 0] * xyz[0] + inv[i, 1] * xyz[1] + inv[i, 2] * xyz[2]).astype(f32)
                    for i in range(3)], -1).astype(np.float64)
    a, b, c = 1 / 1.055, 0.055 / 1.055, 1 / 12.92      # the sRGB curve (type 4), reversed
    disc = (a * 0.04045 + b) ** 2.4
    out = np.where(lin >= disc, (np.abs(lin) ** (1 / 2.4) - b) / a, lin / c).astype(f32)
    return np.clip(np.floor(out.astype(np.float64) * 65535 + 0.5), 0, 65535).astype(np.int64)


def lab_to_rgb(px: np.ndarray) -> np.ndarray:
    """TIFF CIELab samples (L unsigned, a and b signed) -> RGB uint8, as
    PIL's LAB -> RGB conversion gives them: PIL's "LAB" unpacker offsets a
    and b by 128, and LittleCMS evaluates an 8-bit input on _lab_clut by
    its PrelinEval8 (tetrahedral interpolation in 16.16 fixed point), then
    takes 16 bits to 8 (FROM_16_TO_8)."""
    table = _lab_clut()
    i = np.arange(256) * 257 * 32
    v = i + (i + 0x7FFF) // 0xFFFF                         # _cmsToFixedDomain
    node, rest = v >> 16, v & 0xFFFF
    p = px.astype(np.int64) ^ np.array([0, 128, 128])
    x0, y0, z0 = node[p[..., 0]], node[p[..., 1]], node[p[..., 2]]
    rx, ry, rz = rest[p[..., 0]], rest[p[..., 1]], rest[p[..., 2]]
    x1, y1, z1 = x0 + (rx != 0), y0 + (ry != 0), z0 + (rz != 0)

    def d(x, y, z):
        return table[x, y, z]
    c0 = d(x0, y0, z0)
    cases = [  # PrelinEval8's six tetrahedra, in its order: (c1, c2, c3)
        ((rx >= ry) & (ry >= rz), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z0) - d(x1, y0, z0),
                                           d(x1, y1, z1) - d(x1, y1, z0))),
        ((rx >= rz) & (rz >= ry), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z1) - d(x1, y0, z1),
                                           d(x1, y0, z1) - d(x1, y0, z0))),
        ((rz >= rx) & (rx >= ry), lambda: (d(x1, y0, z1) - d(x0, y0, z1),
                                           d(x1, y1, z1) - d(x1, y0, z1), d(x0, y0, z1) - c0)),
        ((ry >= rx) & (rx >= rz), lambda: (d(x1, y1, z0) - d(x0, y1, z0), d(x0, y1, z0) - c0,
                                           d(x1, y1, z1) - d(x1, y1, z0))),
        ((ry >= rz) & (rz >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z0) - c0,
                                           d(x0, y1, z1) - d(x0, y1, z0))),
        ((rz >= ry) & (ry >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1),
                                           d(x0, y1, z1) - d(x0, y0, z1), d(x0, y0, z1) - c0)),
    ]
    c = [np.zeros_like(c0) for _ in range(3)]
    done = np.zeros(rx.shape, bool)
    for cond, terms in cases:
        take = (cond & ~done)[..., None]
        c = [np.where(take, t, old) for t, old in zip(terms(), c)]
        done |= cond
    r = c[0] * rx[..., None] + c[1] * ry[..., None] + c[2] * rz[..., None] + 0x8001
    out16 = (c0 + ((r + (r >> 16)) >> 16)) & 0xFFFF
    return ((out16 * 65281 + 8388608) >> 24).astype(np.uint8)


def _to_rgb(px: np.ndarray, mode: str, photo: int, bits: int, tags) -> np.ndarray:
    if mode == "float":             # PIL's F -> RGB: clipped, then truncated; NaN is 0
        f = px[..., 0]
        g = np.where(np.isnan(f), 0, np.clip(f, 0, 255)).astype(np.uint8)
        return np.repeat(g[..., None], 3, -1)
    if mode in ("int", "grey12"):   # PIL's I and I;16 -> RGB: clipped
        return np.repeat(np.clip(px[..., :1], 0, 255).astype(np.uint8), 3, -1)
    if mode == "lab":
        return lab_to_rgb(px)
    if mode == "grey" or mode == "grey_alpha":
        g = px[..., 0]
        if bits < 8:
            g = g * np.uint8(255 // ((1 << bits) - 1))
        if photo == 0:
            g = 255 - g
        return np.repeat(g[..., None], 3, -1)
    if mode == "grey16":
        return np.repeat(np.minimum(px[..., :1], 255).astype(np.uint8), 3, -1)
    if mode == "palette":
        cmap = np.asarray(tags.get(_COLORMAP, ()), np.int64)
        n = 1 << bits
        if len(cmap) != 3 * n:
            raise ValueError("TIFF: palette image without a ColorMap of 3 * 2 ** bits entries")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap.reshape(3, n).T // 256).astype(np.uint8)
        return pal[px[..., 0]]
    if bits == 16:
        px = (px >> 8).astype(np.uint8)
    if mode == "cmyk":
        c = px[..., :4].astype(np.int64)
        nk = 255 - c[..., 3:4]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    if mode == "rgb_premultiplied":
        a = px[..., 3:4].astype(np.int64)
        rgb = np.minimum(px[..., :3].astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, px[..., :3], rgb))
        return rgb.astype(np.uint8)
    return np.ascontiguousarray(px[..., :3])


def _orient(rgb: np.ndarray, orientation: int) -> np.ndarray:
    """ImageOps.exif_transpose for the Orientation tag's eight values."""
    if orientation == 2:
        return rgb[:, ::-1]
    if orientation == 3:
        return rgb[::-1, ::-1]
    if orientation == 4:
        return rgb[::-1]
    if orientation == 5:
        return rgb.transpose(1, 0, 2)
    if orientation == 6:
        return np.rot90(rgb, -1)
    if orientation == 7:
        return rgb[::-1, ::-1].transpose(1, 0, 2)
    if orientation == 8:
        return np.rot90(rgb, 1)
    return rgb
