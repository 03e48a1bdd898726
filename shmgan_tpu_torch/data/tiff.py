"""Baseline TIFF decoding in numpy and the standard library: what the JAX
package gets from PIL's `Image.open(...).convert("RGB")` (TiffImagePlugin,
with libtiff for every compressed file), pixel for pixel.

    rgb = decode_tiff(data)     # (H, W, 3) uint8

Read: the first IFD only, as PIL opens it; byte order II and MM, classic
TIFF and BigTIFF; strips and tiles; planar configuration 1 (chunky) and 2
(one plane a sample); compression none (1), PackBits (32773), LZW (5, the
early-change codes every writer since TIFF 6.0 uses) and Deflate (8,
32946); the horizontal predictor (2) at 8 and 16 bits, with LZW and Deflate
(libtiff reads the tag for no other code); FillOrder 2 (bits reversed in
each byte, undone before decompression) where PIL reads it: uncompressed
and PackBits, not at every depth (`decode_tiff` refuses the rest).

Photometric interpretations, as PIL's OPEN_INFO maps them and `convert`
then turns them to RGB:

  - min-is-white (0) and min-is-black (1) at 1, 2, 4 and 8 bits, min-is-white
    inverted (PIL's "1;I", "L;2I", "L;4I", "L;I"), 2 and 4 bits scaled by 85
    and 17; 16 bits (PIL's I;16 and I;16B, min-is-white little-endian only,
    and not inverted, as PIL reads it), clipped at 255; grey + alpha (LA);
  - RGB at 8 and 16 bits (16: the high byte), with extra samples dropped:
    unassociated or unspecified alpha as stored, associated alpha
    (ExtraSamples 1, PIL's "RGBa") divided out first, v * 255 // a, zero
    where a is zero;
  - palette (3) at 1, 2, 4 and 8 bits, the ColorMap's 16-bit entries // 256;
  - separated CMYK (5) at 8 bits, through PIL's cmyk2rgb.

The Orientation tag is applied (TiffImagePlugin's load_end calls
ImageOps.exif_transpose). Refused with a ValueError that names the
variant: JPEG-in-TIFF (6, 7), the CCITT codes (2, 3, 4), the other codes
PIL hands to libtiff (ThunderScan, SGILog, LZMA, Zstd, WebP), YCbCr and
CIELab photometric, 12-bit, 16-bit CMYK, signed and float samples; and any
layout PIL refuses too ("unknown pixel mode"). A file cut short or corrupt
raises ValueError.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

_COMPRESSION_REFUSED = {
    2: "CCITT modified Huffman (compression 2)", 3: "CCITT Group 3 fax (compression 3)",
    4: "CCITT Group 4 fax (compression 4)", 6: "old-style JPEG-in-TIFF (compression 6)",
    7: "JPEG-in-TIFF (compression 7)", 32771: "raw 16-bit words (compression 32771)",
    32809: "ThunderScan (compression 32809)", 34676: "SGILog (compression 34676)",
    34677: "SGILog24 (compression 34677)", 34925: "LZMA (compression 34925)",
    50000: "Zstd (compression 50000)", 50001: "WebP (compression 50001)",
}
_PHOTOMETRIC_REFUSED = {6: "YCbCr photometric", 8: "CIELab photometric",
                        4: "transparency-mask photometric"}
# tag -> name of the tags the decoder reads
_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTO, _FILL = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _ORIENTATION, _SPP, _ROWS, _STRIP_COUNTS = 273, 274, 277, 278, 279
_PLANAR, _PREDICTOR, _COLORMAP, _TILE_W, _TILE_H = 284, 317, 320, 322, 323
_TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _FORMAT = 324, 325, 338, 339
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
        if kind in (2, 5, 10, 11, 12):      # text, rationals, floats: not read here
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
    if fmt == (3,):
        raise ValueError("TIFF: float samples are not decoded by the port")
    if fmt == (2,):
        raise ValueError("TIFF: signed samples are not decoded by the port")
    if fmt != (1,):
        raise ValueError(f"TIFF: SampleFormat {fmt} is refused by PIL too")
    if photo in (0, 1) and n == 1 and extra == ():
        b = bps[0]
        if b == 12:
            raise ValueError("TIFF: 12-bit grey is not decoded by the port")
        if b in (1, 2, 4, 8):
            return "grey"
        if b == 16 and (bo == "<" and (photo == 1 or fill == 1) or photo == 1 and fill == 1):
            return "grey16"
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
    if photo == 5 and fill == 1:
        if bps == (8,) * 4 and extra == () or bps == (8,) * 5 and extra == (0,) or (
                bps == (8,) * 6 and extra == (0, 0)):
            return "cmyk"
        if bps == (16,) * 4 and extra == ():
            raise ValueError("TIFF: 16-bit CMYK is not decoded by the port")
    if photo in _PHOTOMETRIC_REFUSED:
        raise ValueError(f"TIFF: {_PHOTOMETRIC_REFUSED[photo]} is not decoded by the port")
    raise ValueError(f"TIFF: the layout photometric {photo}, {bps} bits, extra samples "
                     f"{extra}, FillOrder {fill} is refused by PIL too (unknown pixel mode)")


def _unpredict(rows: np.ndarray, spp: int, bits: int, bo: str) -> np.ndarray:
    """Undo the horizontal predictor on (rows, row bytes) uint8: each sample
    the sum of the differences to its left, modulo 2 ** bits."""
    h = rows.shape[0]
    if bits == 8:
        return np.cumsum(rows.reshape(h, -1, spp), axis=1, dtype=np.uint8).reshape(h, -1)
    s = rows.copy().view(bo + "u2").reshape(h, -1, spp)
    s = np.cumsum(s, axis=1, dtype=np.uint16)
    return s.astype(bo + "u2").view(np.uint8).reshape(h, -1)


def _samples(rows: np.ndarray, w: int, spp: int, bits: int, bo: str) -> np.ndarray:
    """(h, row bytes) uint8 -> (h, w, spp) samples: uint8 at up to 8 bits
    (packed depths unpacked, most significant first), uint16 at 16."""
    h = rows.shape[0]
    if bits == 16:
        return rows[:, :2 * w * spp].copy().view(bo + "u2").astype(np.uint16).reshape(h, w, spp)
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
    if compression not in _DECOMPRESS:
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
    if fill == 2 and (compression not in (1, 32773) or compression == 32773 and bits == 1
                      or compression == 1 and (mode == "palette" and bits < 8
                                               or mode == "grey" and photo == 0 and bits == 8)):
        raise ValueError(f"TIFF: FillOrder 2 with compression {compression} at {bits} bits "
                         f"({mode}) is refused by PIL too")
    if planar == 2 and bits == 16 and compression == 1:
        raise ValueError("TIFF: uncompressed 16-bit planar samples (which PIL unpacks as 8-bit "
                         "planes) are not decoded by the port")
    # libtiff reads the Predictor tag for LZW and Deflate only
    predictor = _one(tags, _PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor == 3:
        raise ValueError("TIFF: the floating-point predictor (3) is not decoded by the port")
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: predictor {predictor} is refused by libtiff too")
    if predictor == 2 and bits not in (8, 16):
        raise ValueError(f"TIFF: the horizontal predictor at {bits} bits is refused by "
                         "libtiff too")

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
    row_bytes = (tw * chunk_spp * bits + 7) // 8
    out = np.zeros((planes, h, w, chunk_spp), np.uint16 if bits == 16 else np.uint8)
    decompress = _DECOMPRESS[compression]
    for plane in range(planes):
        for i, (x0, y0) in enumerate(grid):
            k = plane * len(grid) + i
            rows_here = th if _TILE_OFFSETS in tags else min(th, h - y0)
            need = rows_here * row_bytes
            src = data[offsets[k]:offsets[k] + counts[k]]
            if fill == 2 and compression in (1, 32773):
                src = src.translate(_BIT_REVERSE)
            raw = decompress(src, need)
            if len(raw) < need:
                raise ValueError("TIFF: truncated strip or tile data")
            rows = np.frombuffer(raw, np.uint8, count=need).reshape(rows_here, row_bytes)
            if predictor == 2:
                rows = _unpredict(rows, chunk_spp, bits, bo)
            px = _samples(rows, tw, chunk_spp, bits, bo)
            ch, cw = min(th, h - y0), min(tw, w - x0)
            out[plane, y0:y0 + ch, x0:x0 + cw] = px[:ch, :cw]
    px = np.concatenate(list(out), axis=-1) if planes > 1 else out[0]
    rgb = _to_rgb(px, mode, photo, bits, tags)
    return _orient(rgb, _one(tags, _ORIENTATION, 1))


def _to_rgb(px: np.ndarray, mode: str, photo: int, bits: int, tags) -> np.ndarray:
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
