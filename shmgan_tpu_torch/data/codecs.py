"""Image codecs in numpy and zlib: what the JAX package gets from PIL
(decode, `convert("RGB")`, `resize(..., BILINEAR)`) and from
native/loader.cc (`encode_png`).

    rgb = decode(data)                        # (H, W, 3) uint8
    rgb = resize_bilinear(rgb, (256, 256))    # Pillow's BILINEAR, exactly
    data = encode_png(u8)                     # (H, W) or (H, W, 1|3) uint8

Decoded: PNG at 8 bits (colour types 0, 2, 3, 4, 6; types 0 and 3 also at
1, 2 and 4 bits), not interlaced, every row filter; binary PPM (P6) and PGM
(P5) with maxval up to 255; uncompressed 24-bit BMP. Colour follows PIL's
`convert("RGB")`: grey is replicated, alpha is dropped, a palette is looked
up; transparency chunks are ignored. Anything else, JPEG and GIF among it,
raises ValueError.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# Pillow's fixed-point resampling: coefficients in 22 fractional bits
_PRECISION_BITS = 32 - 8 - 2


def decode(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG is not decoded by the port (no decoder without PIL)")
    if data[:6] in (b"GIF87a", b"GIF89a"):
        raise ValueError("GIF is not decoded by the port (no decoder without PIL)")
    raise ValueError("unrecognised image format: the port decodes PNG, PPM/PGM and BMP")


# -- PNG ------------------------------------------------------------------------

def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            break
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG: truncated (no IEND chunk)")


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of (h, 1 + row bytes) uint8 scanlines, bpp bytes a
    pixel (1 below 8 bits). Rows of filter 0 only are the data as stored;
    otherwise every filter is undone along the anti-diagonals of the
    (row, pixel) grid, whose pixels depend only on the diagonal before
    (left, up) and the one before that (up-left)."""
    ftype, data = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if not ftype.any():
        return data.copy()
    h, rowbytes = data.shape
    n = rowbytes // bpp
    f = data.reshape(h, n, bpp).astype(np.int16)
    out = np.zeros((h + 1, n + 1, bpp), np.int16)   # a zero row above, a zero pixel left
    kinds = ftype.astype(np.int16)[:, None]
    for t in range(h + n - 1):
        ys = np.arange(max(0, t - n + 1), min(h, t + 1))
        xs = t - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[ys]
        pred = np.where(k == 0, 0, np.where(k == 1, a, np.where(
            k == 2, b, np.where(k == 3, (a + b) >> 1, paeth))))
        out[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return out[1:, 1:].reshape(h, rowbytes).astype(np.uint8)


def _decode_png(data: bytes) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"PNG: {depth}-bit colour type {ctype} is not decoded by the port")
    if interlace:
        raise ValueError("PNG: interlaced images are not decoded by the port")
    if w == 0 or h == 0:
        raise ValueError("PNG: empty image")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = math.ceil(w * channels * depth / 8)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    if not inflate.eof or len(raw) < h * (rowbytes + 1):
        raise ValueError("PNG: truncated image data")
    rows = np.frombuffer(raw, np.uint8, count=h * (rowbytes + 1)).reshape(h, rowbytes + 1)
    px = _unfilter(rows, max(1, channels * depth // 8))
    if depth < 8:
        # pack 8 // depth samples a byte, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((px[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    px = px.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:min(len(palette), 256)] = palette[:256]
        return full[px[..., 0]]
    if channels <= 2:   # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(img_u8: np.ndarray, level: int = 1) -> bytes:
    """An (H, W) or (H, W, 1|3) uint8 image as PNG: 8-bit grey or RGB, rows
    of filter 0, one zlib stream at `level` (1: fast, the serving default),
    as native/loader.cc writes it."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3) or 0 in img.shape:
        raise ValueError(f"encode_png: expected (H, W) or (H, W, 1|3), got {img_u8.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, w * c + 1), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


# -- PPM / PGM ------------------------------------------------------------------

def _decode_pnm(data: bytes) -> np.ndarray:
    """Binary P6 (RGB) or P5 (grey); header tokens separated by whitespace,
    `#` comments to the end of the line, one whitespace byte before the
    raster. A maxval under 255 is scaled as PIL scales it."""
    pos, tokens = 2, []
    while len(tokens) < 3:
        token = b""
        while pos < len(data):
            ch = data[pos:pos + 1]
            pos += 1
            if ch in b" \t\n\r\x0b\x0c":
                if token:
                    break
            elif ch == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
            else:
                token += ch
        if not token:
            raise ValueError("PNM: truncated header")
        tokens.append(int(token))
    w, h, maxval = tokens
    if not 0 < maxval <= 255:
        raise ValueError(f"PNM: maxval {maxval} (16-bit samples) is not decoded by the port")
    bands = 3 if data[:2] == b"P6" else 1
    n = w * h * bands
    if w <= 0 or h <= 0 or len(data) - pos < n:
        raise ValueError("PNM: truncated raster")
    px = np.frombuffer(data, np.uint8, count=n, offset=pos).reshape(h, w, bands)
    if maxval != 255:
        px = np.minimum(255, np.round(px / maxval * 255)).astype(np.uint8)
    return np.repeat(px, 3, axis=-1) if bands == 1 else px.copy()


# -- BMP ------------------------------------------------------------------------

def _decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed 24-bit BMP (BITMAPINFOHEADER or later), bottom-up or
    top-down."""
    if len(data) < 54:
        raise ValueError("BMP: truncated header")
    (offset,) = struct.unpack("<I", data[10:14])
    size, w, h, _, bits, compression = struct.unpack("<IiiHHI", data[14:34])
    if size < 40:
        raise ValueError("BMP: only BITMAPINFOHEADER (or later) files are decoded by the port")
    if bits != 24 or compression != 0:
        raise ValueError(f"BMP: {bits}-bit, compression {compression}: only uncompressed "
                         f"24-bit BMP is decoded by the port")
    if w <= 0 or h == 0:
        raise ValueError("BMP: empty image")
    stride = (w * 3 + 3) // 4 * 4
    rows = abs(h)
    if len(data) < offset + stride * rows:
        raise ValueError("BMP: truncated pixel data")
    px = np.frombuffer(data, np.uint8, count=stride * rows, offset=offset)
    px = px.reshape(rows, stride)[:, :w * 3].reshape(rows, w, 3)[..., ::-1]
    return np.ascontiguousarray(px[::-1] if h > 0 else px)


# -- resize -----------------------------------------------------------------------

def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pillow's bilinear coefficients (Resample.c precompute_coeffs, then
    normalize_coeffs_8bpc): for each output index the first input index, and
    the int weights (22 fractional bits) over the taps, zero past the last."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale             # the triangle filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    ss = 1.0 / filterscale
    w = np.maximum(0.0, 1.0 - np.abs((taps[None] + xmin[:, None] - center[:, None] + 0.5) * ss))
    w[taps[None] >= xmax[:, None]] = 0.0
    total = np.zeros(out_size)
    for k in range(ksize):            # in tap order, as Pillow sums
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS), 0.5 + w * (1 << _PRECISION_BITS))
    return xmin, np.trunc(fixed).astype(np.int64), ksize


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, k, ksize = _coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None], in_size - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(ksize):
        acc += src[idx[:, t]] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C) uint8, as Pillow's
    `Image.resize((w, h), BILINEAR)` computes it: a horizontal then a vertical
    pass, each only when that axis changes, each rounded and clipped to
    uint8; on a downscale the triangle widens by the scale factor."""
    out_h, out_w = size
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return img
