"""Image codecs in numpy and zlib: what the JAX package gets from PIL
(decode, `convert("RGB")`, `resize(..., BILINEAR)`) and from
native/loader.cc (`encode_png`).

    rgb = decode(data)                        # (H, W, 3) uint8
    rgb = resize_bilinear(rgb, (256, 256))    # Pillow's BILINEAR, exactly
    data = encode_png(u8)                     # (H, W) or (H, W, 1|3) uint8
    data = encode_ppm(u8); encode_bmp(u8)     # PIL's P6/P5 and 24-bit BMP bytes

`decode` dispatches on the file's signature, as `Image.open` does (never on
its name), and reads what PIL 12 reads of these formats, to PIL's
`convert("RGB")` pixels:

  - JPEG: baseline, extended sequential and progressive, Huffman or
    arithmetic coding, and lossless (SOF3), 8-bit, 1, 3 or 4 components
    (CMYK, and YCCK by Adobe's transform 2, inverted as PIL reads them)
    (data/jpeg.py);
  - GIF: the first frame, global or local colour table, interlaced or not
    (data/gif.py);
  - WebP: lossy (VP8), lossless (VP8L), VP8X with alpha and metadata, an
    animation's first frame (data/webp.py);
  - TIFF: the first IFD, strips and tiles, none/PackBits/LZW/Deflate/LZMA/
    Zstd/JPEG/CCITT (Modified Huffman, T.4, T.6), predictors 2 and 3, grey
    at 1-16 bits, float and signed samples, RGB, palette, CMYK at 8 and 16
    bits, YCbCr and CIELab (data/tiff.py, data/zstd.py, data/ccitt.py);
  - JPEG 2000: a JP2 file or a raw codestream, reversible 5/3 or
    irreversible 9/7, with or without the colour transform, tiles,
    offsets, precincts, every progression, quality layers, 1-16 bits,
    signed or not, grey, grey+alpha, RGB, RGBA, CMYK and palette JP2
    (data/jpeg2000.py, its tier 1 in csrc/jpeg2000_t1.cc);
  - PNG: every colour type at every bit depth, 16 bits included, Adam7
    interlaced or not, every row filter;
  - PNM: binary P6 (PPM) and P5 (PGM) at every maxval, 16-bit samples
    included; plain P3 and P2; bilevel P1 and P4 (PBM);
  - BMP: 1-, 4- and 8-bit palettes, 16-bit 555 and 565, 24-bit, 32-bit, the
    BITFIELDS layouts PIL knows, RLE8 and RLE4, bottom-up or top-down, the
    Windows headers and OS/2's BITMAPCOREHEADER.

Colour follows PIL's `convert("RGB")`, which does not scale every format
the same way: grey is replicated, alpha and transparency are dropped, a
palette is looked up (zeros past its end); a 16-bit grey PNG and a PGM of
maxval above 255 clip at 255 (PIL's modes I;16 and I), a 16-bit RGB or
grey+alpha PNG keeps the high byte, a PPM of maxval other than 255 is
scaled by round(v / maxval * 255).

Formats PIL opens that the port does not decode raise a ValueError that
names them where their signature does: AVIF, PSD, QOI, ICO/CUR, DDS, SGI,
PCX, PFM, TGA (by its footer), ICNS, MSP, XBM (`_UNPORTED`), and the
variants of a ported format the port does not read, each by name (12-bit,
hierarchical and lossless arithmetic-coded JPEG, which PIL refuses too; the
TIFF codes and layouts data/tiff.py lists; the JPEG 2000 features
data/jpeg2000.py lists, HTJ2K first). So does
input that is truncated, corrupt or not an image, and, from its header
before anything is allocated, an image of more pixels than PIL opens
(`check_size`).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

# PIL's Image.MAX_IMAGE_PIXELS: Image.open refuses an image of more than twice
# this many pixels (DecompressionBombError) before it decodes any of it
MAX_IMAGE_PIXELS = 89478485
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
# Pillow's fixed-point resampling: coefficients in 22 fractional bits
_PRECISION_BITS = 32 - 8 - 2


def check_size(kind: str, w: int, h: int) -> None:
    """Refuse, as PIL does and before anything is allocated, an image whose
    header claims more than 2 * MAX_IMAGE_PIXELS pixels."""
    pixels = max(1, w) * max(1, h)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{kind}: {w}x{h} is {pixels} pixels, more than the "
                         f"{2 * MAX_IMAGE_PIXELS} PIL opens")


# formats PIL opens that the port does not decode, by their signatures:
# (offset, bytes, name)
_UNPORTED = (
    (4, b"ftypavif", "AVIF"), (4, b"ftypavis", "AVIF"),
    (0, b"8BPS", "PSD"), (0, b"qoif", "QOI"), (0, b"DDS ", "DDS"),
    (0, b"\x00\x00\x01\x00", "ICO"), (0, b"\x00\x00\x02\x00", "CUR"),
    (0, b"\x01\xda", "SGI"), (0, b"icns", "ICNS"), (0, b"DanM", "MSP"), (0, b"LinS", "MSP"),
    (0, b"#define", "XBM"), (0, b"Pf", "PFM"),
)


def decode(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB. The format is told by its
    signature, as `Image.open` tells it, never by a file name."""
    from shmgan_tpu_torch.data.gif import decode_gif     # each imports check_size
    from shmgan_tpu_torch.data.jpeg import decode_jpeg
    from shmgan_tpu_torch.data.jpeg2000 import J2K_SIGNATURE, JP2_SIGNATURE, decode_jpeg2000
    from shmgan_tpu_torch.data.tiff import TIFF_SIGNATURES, decode_tiff
    from shmgan_tpu_torch.data.webp import decode_webp

    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data)
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        return _decode_pnm(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data)
    if data.startswith(JP2_SIGNATURE) or data.startswith(J2K_SIGNATURE):
        return decode_jpeg2000(data)
    if data[-18:] == b"TRUEVISION-XFILE.\x00":    # before CUR: a TGA may start alike
        raise ValueError("TGA: PIL opens this format, the port does not decode it")
    for offset, magic, name in _UNPORTED:
        if data[offset:offset + len(magic)] == magic:
            raise ValueError(f"{name}: PIL opens this format, the port does not decode it")
    if data[:1] == b"\x0a" and data[1:2] in (b"\x00", b"\x02", b"\x03", b"\x05"):
        raise ValueError("PCX: PIL opens this format, the port does not decode it")
    raise ValueError("unrecognised image format: the port decodes PNG, JPEG, GIF, WebP, "
                     "TIFF, JPEG 2000, PNM (P1-P6) and BMP")


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


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (h, row bytes) -> (h, w, channels) samples:
    uint16 at 16 bits (big-endian), else uint8 (packed depths unpacked,
    most significant first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * w * channels].copy().view(">u2").astype(np.uint16).reshape(
            h, w, channels)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return rows[:, :w * channels].reshape(h, w, channels)


def _decode_png(data: bytes) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"PNG: bit depth {depth} is not valid for colour type {ctype}")
    if interlace > 1:
        raise ValueError(f"PNG: unknown interlace method {interlace}")
    if w == 0 or h == 0:
        raise ValueError("PNG: empty image")
    check_size("PNG", w, h)
    channels = _PNG_CHANNELS[ctype]
    # (first row, first column, row step, column step, width, height, row
    # bytes) of each pass that has pixels (a pass with none has no scanlines)
    passes = [(y0, x0, dy, dx, pw, ph, math.ceil(pw * channels * depth / 8))
              for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),))
              for pw, ph in [(-(-(w - x0) // dx), -(-(h - y0) // dy))] if pw > 0 and ph > 0]
    need = sum(ph * (rowbytes + 1) for *_, ph, rowbytes in passes)
    inflate = zlib.decompressobj()
    try:   # no more than the scanlines need: extra data inflates no further
        raw = inflate.decompress(b"".join(idat), need + 1)
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    if len(raw) < need or (len(raw) == need and not inflate.eof):
        raise ValueError("PNG: truncated image data")
    px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx, pw, ph, rowbytes in passes:
        n = ph * (rowbytes + 1)
        rows = np.frombuffer(raw, np.uint8, count=n, offset=pos).reshape(ph, rowbytes + 1)
        pos += n
        unfiltered = _unfilter(rows, max(1, channels * depth // 8))
        px[y0::dy, x0::dx] = _samples(unfiltered, pw, channels, depth)
    if depth == 16:
        if ctype == 0:                  # PIL's I;16, whose convert("RGB") clips
            px = np.minimum(px, 255)
        else:                           # RGB;16B, LA;16B, RGBA;16B: the high byte
            px = px >> 8
        px = px.astype(np.uint8)
    elif depth < 8 and ctype == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))
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
    img = _encodable(img_u8, "encode_png")
    h, w, c = img.shape
    raw = np.zeros((h, w * c + 1), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def encode_ppm(img_u8: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1|3) uint8 as binary PGM (P5) or PPM (P6) of maxval
    255, the bytes PIL's `save` writes."""
    img = _encodable(img_u8, "encode_ppm")
    h, w, c = img.shape
    return b"P%d\n%d %d\n255\n" % (5 if c == 1 else 6, w, h) + img.tobytes()


def encode_bmp(img_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 as an uncompressed 24-bit bottom-up BMP, the bytes
    PIL's `save` writes for an RGB image (96 dpi)."""
    img = _encodable(img_u8, "encode_bmp")
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_bmp: expected (H, W, 3), got {img_u8.shape}")
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    ppm = int(96 * 39.3701 + 0.5)
    return (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, ppm, ppm, 0, 0)
            + rows.tobytes())


def _encodable(img_u8: np.ndarray, what: str) -> np.ndarray:
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise ValueError(f"{what}: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3) or 0 in img.shape:
        raise ValueError(f"{what}: expected (H, W) or (H, W, 1|3), got {img_u8.shape}")
    return img


# -- PNM (PBM, PGM, PPM) ------------------------------------------------------------

_PNM_WHITESPACE = b" \t\n\x0b\x0c\r"


def _pnm_token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """PpmImagePlugin._read_token: skip whitespace, read up to the next
    whitespace byte (consumed); a `#` drops the rest of its line, newline
    included, and the token goes on after it."""
    token = b""
    while len(token) <= 10:
        ch = data[pos:pos + 1]
        pos += 1
        if not ch:
            break
        if ch in _PNM_WHITESPACE:
            if token:
                break
        elif ch == b"#":
            while data[pos:pos + 1] and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
        else:
            token += ch
    if not token:
        raise ValueError("PNM: truncated header")
    if len(token) > 10 or not token.isdigit():
        raise ValueError(f"PNM: bad header token {token[:16]!r}")
    return token, pos


def _pnm_uncommented(body: bytes) -> bytes:
    """The raster of a plain (ASCII) PNM with its comments taken out, as
    PpmPlainDecoder takes them: from `#` to the next CR or LF, that byte
    included, the text on either side joined."""
    parts, pos = [], 0
    while True:
        start = body.find(b"#", pos)
        if start < 0:
            parts.append(body[pos:])
            return b"".join(parts)
        parts.append(body[pos:start])
        ends = [e for e in (body.find(b"\n", start), body.find(b"\r", start)) if e >= 0]
        if not ends:
            return b"".join(parts)
        pos = min(ends) + 1


def _decode_pnm(data: bytes) -> np.ndarray:
    """PBM, PGM and PPM as PpmImagePlugin reads them.

    Binary P6 (RGB) and P5 (grey) at any maxval below 65536, samples of two
    bytes, big-endian, past 255: maxval 255 as stored, P5 at 65535 as stored
    (mode I), any other maxval through PIL's PpmDecoder, round(v / maxval *
    255) (P6, P5 up to 255) or * 65535 (P5 past 255, mode I); `convert("RGB")`
    then clips mode I at 255. Plain P3 and P2 (PpmPlainDecoder): decimal
    samples, each scaled by round(v / maxval * 255), or * 65535 for a P2 past
    maxval 255; a sample past maxval is refused. P1 (plain) and P4 (packed
    rows, most significant bit first): 1 is black, 0 white. Header tokens are
    separated by whitespace, `#` comments run to the end of their line, and
    one whitespace byte ends the header."""
    magic = data[:6]
    for i, b in enumerate(magic):
        if b in _PNM_WHITESPACE:
            magic = magic[:i]
            break
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError(f"PNM: unknown magic number {magic!r}")
    pos = len(magic) + 1
    tokens = []
    for _ in range(2 if magic in (b"P1", b"P4") else 3):
        token, pos = _pnm_token(data, pos)
        tokens.append(int(token))
    w, h = tokens[:2]
    check_size("PNM", w, h)
    if w <= 0 or h <= 0:
        raise ValueError("PNM: empty image")
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            stride = (w + 7) // 8
            if len(data) - pos < stride * h:
                raise ValueError("PNM: truncated raster")
            rows = np.frombuffer(data, np.uint8, count=stride * h, offset=pos).reshape(h, stride)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            digits = b"".join(_pnm_uncommented(data[pos:]).split())
            if digits.translate(None, b"01"):
                raise ValueError("PNM: a P1 sample is not 0 or 1")
            digits = digits[:w * h]
            if len(digits) < w * h:
                raise ValueError("PNM: truncated raster")
            bits = (np.frombuffer(digits, np.uint8) - 48).reshape(h, w)
        return np.repeat(np.where(bits[..., None] == 1, 0, 255).astype(np.uint8), 3, -1)
    maxval = tokens[2]
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM: maxval {maxval} is outside (0, 65536)")
    bands = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * bands
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    if magic in (b"P2", b"P3"):
        words = _pnm_uncommented(data[pos:]).split()
        if len(words) < n:
            raise ValueError("PNM: truncated raster")
        values = []
        for word in words[:n]:
            if len(word) > 10:
                raise ValueError(f"PNM: sample token too long ({word[:11]!r})")
            v = int(word)
            if not 0 <= v <= maxval:
                raise ValueError(f"PNM: sample {v} is outside [0, maxval {maxval}]")
            values.append(v)
        px = np.asarray(values, np.int64).reshape(h, w, bands)
        px = np.round(px / maxval * out_max).astype(np.int64)
    else:
        size = 1 if maxval < 256 else 2
        if len(data) - pos < n * size:
            raise ValueError("PNM: truncated raster")
        px = np.frombuffer(data, np.uint8 if size == 1 else ">u2", count=n, offset=pos)
        px = px.reshape(h, w, bands).astype(np.int64)
        if maxval != out_max:
            px = np.minimum(out_max, np.round(px / maxval * out_max).astype(np.int64))
    px = np.minimum(px, 255).astype(np.uint8)
    return np.repeat(px, 3, axis=-1) if bands == 1 else px


# -- BMP ------------------------------------------------------------------------

# BITFIELDS masks PIL knows -> the byte offsets of R, G, B in a 32-bit pixel
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),            # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),      # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),          # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),     # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),     # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),     # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),     # BGAR
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),                     # BGRA
}
_BMP_MASKS16 = {(0xF800, 0x7E0, 0x1F): 6, (0x7C00, 0x3E0, 0x1F): 5}   # green bits


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """PIL's BmpRleDecoder, step for step (its delta escape reads two bytes
    more than it uses, as PIL's does): (h * w) indices in file row order."""
    out = bytearray()
    x, n = 0, w * h
    while len(out) < n:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = max(0, w - x) if x + count > w else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                 # end of line
            out += bytes((-len(out)) % w)
            x = 0
        elif byte == 1:                 # end of bitmap
            break
        elif byte == 2:                 # delta
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise ValueError("BMP: truncated RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                           # absolute run
            got = data[pos:pos + (byte // 2 if rle4 else byte)]
            pos += len(got)
            if rle4:
                out += bytes(v for b in got for v in (b >> 4, b & 15))
            else:
                out += got
            if len(got) < (byte // 2 if rle4 else byte):
                break
            x += byte
            pos += pos % 2              # PIL aligns to the file's 16-bit words
    if len(out) < n:
        raise ValueError("BMP: truncated RLE data")
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


def _decode_bmp(data: bytes) -> np.ndarray:
    """BMP as PIL's BmpImagePlugin reads it: the header kinds, bit depths,
    BITFIELDS layouts and RLE of its tables, and nothing else."""
    if len(data) < 18:
        raise ValueError("BMP: truncated header")
    offset, hsize = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    hd = data[18:14 + hsize]
    if hsize < 12 or len(hd) < hsize - 4:
        raise ValueError("BMP: truncated header")
    pos = 14 + hsize
    masks = None
    if hsize == 12:                     # OS/2 BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        compression, colors, pal_pad, bottom_up = 0, 0, 3, True
    elif hsize in (40, 52, 56, 64, 108, 124):
        bottom_up = hd[7] != 0xFF
        w, h = struct.unpack("<II", hd[:8])
        if not bottom_up:
            h = 2 ** 32 - h
        bits, compression = struct.unpack("<HI", hd[10:16])
        (colors,) = struct.unpack("<I", hd[28:32])
        pal_pad = 4
        if compression == 3:
            if len(hd) >= 48:
                masks = struct.unpack("<III", hd[36:48]) + (
                    struct.unpack("<I", hd[48:52]) if len(hd) >= 52 else (0,))
            else:
                if len(data) < pos + 12:
                    raise ValueError("BMP: truncated header")
                masks = struct.unpack("<III", data[pos:pos + 12]) + (0,)
                pos += 12
    else:
        raise ValueError(f"BMP: header size {hsize} is not one PIL reads")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP: {bits} bits a pixel is not one PIL reads")
    if w == 0 or h == 0:
        raise ValueError("BMP: empty image")
    check_size("BMP", w, h)
    if compression == 3:
        if bits == 32 and masks in _BMP_MASKS32:
            layout = _BMP_MASKS32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            layout = None
        elif bits == 16 and masks[:3] in _BMP_MASKS16:
            layout = _BMP_MASKS16[masks[:3]]
        else:
            raise ValueError(f"BMP: BITFIELDS layout {masks} is not one PIL reads")
    elif compression == 0:
        layout = 5 if bits == 16 else (2, 1, 0) if bits == 32 else None
    elif compression in (1, 2):
        layout = None
    else:
        raise ValueError(f"BMP: compression {compression} is not one PIL reads")

    palette, mode = None, "RGB"
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: palette of {colors} colours")
        raw = data[pos:pos + pal_pad * colors]
        grey = all(raw[i * pal_pad:i * pal_pad + 3] == bytes([v]) * 3 for i, v in
                   enumerate((0, 255) if colors == 2 else range(colors)))
        if grey:
            mode = "1" if colors == 2 else "L"
        else:
            mode = "P"
            entries = np.frombuffer(raw[:len(raw) // pal_pad * pal_pad], np.uint8)
            entries = entries.reshape(-1, pal_pad)[:256, 2::-1]        # BGR(X) -> RGB
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(entries)] = entries

    if compression in (1, 2):
        idx = _bmp_rle(data, offset, w, h, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if len(data) < offset + stride * h:
            raise ValueError("BMP: truncated pixel data")
        rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset).reshape(h, stride)
        unpack = {"1": 1, "L": 8}.get(mode, bits)      # PIL's raw modes "1" and "L"
        if unpack < 8:
            shifts = np.arange(8 - unpack, -1, -unpack, dtype=np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << unpack) - 1)).reshape(h, -1)[:, :w]
        elif bits <= 8:
            idx = rows[:, :w]
        elif bits == 16:
            p = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
            gbits = layout
            r = ((p >> (5 + gbits)) & 31) * 255 // 31
            g = ((p >> 5) & ((1 << gbits) - 1)) * 255 // ((1 << gbits) - 1)
            b = (p & 31) * 255 // 31
            idx = np.stack([r, g, b], -1).astype(np.uint8)
        else:
            nb = bits // 8
            px = rows[:, :nb * w].reshape(h, w, nb)
            idx = px[..., list(layout)] if layout else px[..., ::-1]
    if bottom_up:
        idx = idx[::-1]
    if mode == "1":
        return np.repeat(np.where(idx[..., None] != 0, 255, 0).astype(np.uint8), 3, -1)
    if mode == "L":
        return np.repeat(np.ascontiguousarray(idx)[..., None], 3, -1)
    if mode == "P":
        return palette[idx]
    return np.ascontiguousarray(idx)


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
