"""Image codecs in numpy and zlib: what the JAX package gets from PIL
(decode, `convert("RGB")`, `resize(..., BILINEAR)`) and from
native/loader.cc (`encode_png`).

    rgb = decode(data)                        # (H, W, 3) uint8
    rgb = resize_bilinear(rgb, (256, 256))    # Pillow's BILINEAR, exactly
    data = encode_png(u8)                     # (H, W) or (H, W, 1|3) uint8
    data = encode_ppm(u8); encode_bmp(u8)     # PIL's P6/P5 and 24-bit BMP bytes

`decode` tells a file by its bytes as `Image.open` does (never by its
name): PIL 12's plugins in its order (`_open_order`), each taking the
bytes where PIL's `_accept` and `_open` would and passing them on
(NotThisFormat) where PIL's would; TGA, which has no signature, is tried
on nearly everything. It reads what PIL 12 reads of these formats, to
PIL's `convert("RGB")` pixels:

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
    included; plain P3 and P2; bilevel P1 and P4 (PBM); PFM's grey `Pf`;
  - BMP and the headerless DIB: 1-, 4- and 8-bit palettes, 16-bit 555 and
    565, 24-bit, 32-bit, the BITFIELDS layouts PIL knows, RLE8 and RLE4,
    bottom-up or top-down, the Windows headers and OS/2's
    BITMAPCOREHEADER;
  - TGA (data/tga.py), PSD (data/psd.py), ICO, CUR and ICNS
    (data/icons.py), QOI (data/qoi.py), PCX and DCX (data/pcx.py), SGI
    (data/sgi.py), DDS with every block format PIL reads (data/dds.py),
    MSP and XBM.

Colour follows PIL's `convert("RGB")`, which does not scale every format
the same way: grey is replicated, alpha and transparency are dropped, a
palette is looked up (zeros past its end); a 16-bit grey PNG and a PGM of
maxval above 255 clip at 255 (PIL's modes I;16 and I), a 16-bit RGB or
grey+alpha PNG keeps the high byte, a PPM of maxval other than 255 is
scaled by round(v / maxval * 255), PFM's floats clip to [0, 255] and
truncate.

Formats PIL opens that the port does not decode raise a ValueError naming
them where their `_accept` takes the bytes: AVIF, BLP, BUFR, EPS, FITS,
FTEX, GRIB, HDF5, MCIDAS, MPEG, PIXAR, SUN, WMF, XPM, XVTHUMB and PIL's
own PPM variants (P0CMYK, PyP, PyRGBA, PyCMYK); IM, IMT, IPTC, PCD and
SPIDER (which have no `_accept`), GBR and FLI fall to "unrecognised".
So do the variants of a ported format the port does not read, each by
name (12-bit, hierarchical and lossless arithmetic-coded JPEG, which PIL
refuses too; the TIFF codes and layouts data/tiff.py lists; the JPEG 2000
features data/jpeg2000.py lists, HTJ2K first). So does input that is
truncated, corrupt or not an image, and, from its header before anything
is allocated, an image of more pixels than PIL opens (`check_size`).
"""

from __future__ import annotations

import functools
import math
import re
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


class NotThisFormat(ValueError):
    """The bytes are not this plugin's after all: where PIL's `_open` raises
    SyntaxError (or IndexError, TypeError, KeyError, EOFError or
    struct.error, which ImageFile turns into SyntaxError), or opens an empty
    image, `Image.open` goes on to the next plugin, and so does `decode`."""


def _refused(name: str):
    def refuse(data: bytes) -> np.ndarray:
        raise ValueError(f"{name}: PIL opens this format, the port does not decode it")
    return refuse


def _starts(*magics: bytes):
    return lambda data: data.startswith(magics)


def _i32(data: bytes, fmt: str = "<I") -> int:
    return struct.unpack(fmt, data[:4])[0] if len(data) >= 4 else -1


def _ppm_accept(data: bytes) -> bool:
    return data[:1] == b"P" and len(data) >= 2 and data[1] in b"0123456fy"


@functools.lru_cache(maxsize=1)
def _open_order() -> tuple:
    """(name, accept, decoder) in the order `Image.open` tries PIL 12's
    plugins: the five it imports first (BMP with DIB, GIF, JPEG, PPM, PNG),
    then the rest in `Image.ID` order. `accept` sees the bytes as PIL's
    `_accept` sees the first 16. A plugin PIL opens and the port does not
    decode refuses by name where its `_accept` takes the bytes; IM, IMT,
    IPTC, PCD and SPIDER (no `_accept`), GBR and FLI are not emulated, and
    their files fall to "unrecognised"."""
    from shmgan_tpu_torch.data import dds, icons, pcx, psd, qoi, sgi, tga
    from shmgan_tpu_torch.data.gif import decode_gif
    from shmgan_tpu_torch.data.jpeg import decode_jpeg
    from shmgan_tpu_torch.data.jpeg2000 import J2K_SIGNATURE, JP2_SIGNATURE, decode_jpeg2000
    from shmgan_tpu_torch.data.tiff import TIFF_SIGNATURES, decode_tiff
    from shmgan_tpu_torch.data.webp import decode_webp

    return (
        ("BMP", _starts(b"BM"), _decode_bmp),
        ("DIB", lambda d: _i32(d) in _DIB_HEADERS, decode_dib),
        ("GIF", _starts(b"GIF87a", b"GIF89a"), decode_gif),
        ("JPEG", _starts(b"\xff\xd8\xff"), decode_jpeg),
        ("PPM", _ppm_accept, _decode_ppm),
        ("PNG", _starts(PNG_SIGNATURE), _decode_png),
        ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
         _refused("AVIF")),
        ("BLP", _starts(b"BLP1", b"BLP2"), _refused("BLP")),
        ("BUFR", _starts(b"BUFR", b"ZCZC"), _refused("BUFR")),
        ("CUR", _starts(b"\x00\x00\x02\x00"), icons.decode_cur),
        ("PCX", lambda d: d[:1] == b"\x0a" and d[1:2] in (b"\x00", b"\x02", b"\x03", b"\x05"),
         pcx.decode_pcx),
        ("DCX", lambda d: _i32(d) == pcx.DCX_MAGIC, pcx.decode_dcx),
        ("DDS", _starts(b"DDS "), dds.decode_dds),
        ("EPS", lambda d: d.startswith(b"%!PS") or _i32(d) == 0xC6D3D0C5, _refused("EPS")),
        ("FITS", _starts(b"SIMPLE"), _refused("FITS")),
        ("FTEX", _starts(b"FTEX"), _refused("FTEX")),
        ("GRIB", lambda d: d.startswith(b"GRIB") and d[7:8] == b"\x01", _refused("GRIB")),
        ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), _refused("HDF5")),
        ("JPEG2000", _starts(JP2_SIGNATURE, J2K_SIGNATURE), decode_jpeg2000),
        ("ICNS", _starts(b"icns"), icons.decode_icns),
        ("ICO", _starts(b"\x00\x00\x01\x00"), icons.decode_ico),
        ("MCIDAS", _starts(b"\x00\x00\x00\x00\x00\x00\x00\x04"), _refused("MCIDAS")),
        ("MPEG", _starts(b"\x00\x00\x01\xb3"), _refused("MPEG")),
        ("TIFF", _starts(*TIFF_SIGNATURES), decode_tiff),
        ("MSP", _starts(b"DanM", b"LinS"), _decode_msp),
        ("PIXAR", _starts(b"\x80\xe8\x00\x00"), _refused("PIXAR")),
        ("PSD", _starts(b"8BPS"), psd.decode_psd),
        ("QOI", _starts(b"qoif"), qoi.decode_qoi),
        ("SGI", lambda d: d[:2] == b"\x01\xda", sgi.decode_sgi),
        ("SUN", lambda d: _i32(d, ">I") == 0x59A66A95, _refused("SUN")),
        ("TGA", lambda d: True, tga.decode_tga),       # no _accept: tried on the rest
        ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", decode_webp),
        ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _refused("WMF")),
        ("XBM", lambda d: d[:16].lstrip().startswith(b"#define"), _decode_xbm),
        ("XPM", _starts(b"/* XPM */"), _refused("XPM")),
        ("XVTHUMB", _starts(b"P7 332"), _refused("XVTHUMB")),
    )


_DECODED = ("PNG, JPEG, GIF, WebP, TIFF, JPEG 2000, PNM (P1-P6), PFM, BMP, DIB, TGA, PSD, "
            "ICO, CUR, ICNS, QOI, PCX, DCX, SGI, MSP, XBM and DDS")


def decode(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB. The format is told by its
    bytes, as `Image.open` tells it, never by a file name: each plugin in
    PIL's order, passing on where PIL's would (NotThisFormat)."""
    data = bytes(data)
    head = data[:16]
    for _, accept, decoder in _open_order():
        if accept(head):
            try:
                return decoder(data)
            except NotThisFormat:
                continue
    raise ValueError(f"unrecognised image format: the port decodes {_DECODED}")


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


def _pnm_token(data: bytes, pos: int, digits: bool = True) -> Tuple[bytes, int]:
    """PpmImagePlugin._read_token: skip whitespace, read up to the next
    whitespace byte (consumed); a `#` drops the rest of its line, newline
    included, and the token goes on after it. With `digits`, a token of
    other than decimal digits is refused."""
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
    if len(token) > 10 or (digits and not token.isdigit()):
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


def _decode_ppm(data: bytes) -> np.ndarray:
    """PpmImagePlugin's magic: up to 6 bytes, to the first whitespace. P1-P6
    are PNM, Pf is PFM; PIL's own P0CMYK, PyP, PyRGBA and PyCMYK are
    refused by name; anything else is not PIL's PPM."""
    magic = data[:6]
    for i, b in enumerate(magic):
        if b in _PNM_WHITESPACE:
            magic = magic[:i]
            break
    if magic in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        return _decode_pnm(data)
    if magic == b"Pf":
        return _decode_pfm(data, len(magic) + 1)
    if magic in (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK"):
        raise ValueError(f"PPM: PIL opens {magic.decode()}, the port does not decode it")
    raise NotThisFormat(f"PPM: unknown magic number {magic!r}")


def _decode_pfm(data: bytes, pos: int) -> np.ndarray:
    """PFM's grey `Pf` as PpmImagePlugin reads it (mode F): width, height and
    scale tokens, then float32 samples, little-endian if the scale is
    negative, rows bottom-up; `convert("RGB")` clips to [0, 255] and
    truncates, NaN to 0. (PIL opens no colour `PF`.)"""
    tokens = []
    for _ in range(3):
        token, pos = _pnm_token(data, pos, digits=False)
        tokens.append(token)
    try:
        w, h = int(tokens[0]), int(tokens[1])
    except ValueError:
        raise ValueError(f"PFM: bad size tokens {tokens[:2]}") from None
    if w <= 0 or h <= 0:
        raise NotThisFormat("PFM: empty image")
    check_size("PFM", w, h)
    try:
        scale = float(tokens[2])
    except ValueError:
        raise ValueError(f"PFM: bad scale token {tokens[2]!r}") from None
    if scale == 0.0 or not math.isfinite(scale):
        raise ValueError("PFM: the scale must be finite and non-zero")
    if len(data) - pos < 4 * w * h:
        raise ValueError("PFM: truncated raster")
    f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", count=w * h, offset=pos)
    g = np.where(np.isnan(f), 0, np.clip(f, 0, 255)).astype(np.uint8).reshape(h, w)[::-1]
    return np.repeat(g[..., None], 3, -1)


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


# -- MSP, XBM ---------------------------------------------------------------------

def _bilevel(rows: np.ndarray, w: int, lsb_first: bool = False) -> np.ndarray:
    """(h, stride) packed rows -> (h, w, 3) uint8 as PIL's mode "1" gives
    them to RGB: a set bit is 255."""
    bits = np.unpackbits(rows, axis=1, bitorder="little" if lsb_first else "big")[:, :w]
    return np.repeat((bits * np.uint8(255))[..., None], 3, -1)


def _decode_msp(data: bytes) -> np.ndarray:
    """Windows Paint as MspImagePlugin reads it: a 32-byte header whose 16
    little-endian words XOR to 0; v1 (DanM) raw rows, v2 (LinS) a row map
    then rows of runs (0, count, value) and literals (count, bytes), an
    empty row white. The rows are joined as PIL joins them, whatever their
    lengths, and must fill the image."""
    if len(data) < 32:
        raise NotThisFormat("MSP: truncated header")
    words = struct.unpack("<16H", data[:32])
    if functools.reduce(lambda a, b: a ^ b, words):
        raise NotThisFormat("MSP: bad header checksum")
    w, h = words[2], words[3]
    if w == 0 or h == 0:
        raise NotThisFormat("MSP: empty image")
    check_size("MSP", w, h)
    stride = (w + 7) // 8
    if data.startswith(b"DanM"):
        if len(data) < 32 + stride * h:
            raise ValueError("MSP: truncated image data")
        raw = data[32:32 + stride * h]
    else:
        if len(data) < 32 + 2 * h:
            raise ValueError("MSP: truncated row map")
        out, pos, need = bytearray(), 32 + 2 * h, stride * h
        blank = b"\xff" * stride
        for y, n in enumerate(struct.unpack_from(f"<{h}H", data, 32)):
            if n == 0:
                out += blank
                continue
            row = data[pos:pos + n]
            pos += n
            if len(row) != n:
                raise ValueError(f"MSP: truncated row {y}")
            i = 0
            while i < n:       # every row is read, as PIL reads it; the bytes kept stop at
                if row[i] == 0:                 # the image's end
                    if i + 3 > n:
                        raise ValueError(f"MSP: corrupt row {y}")
                    if len(out) < need:
                        out += row[i + 2:i + 3] * row[i + 1]
                    i += 3
                else:
                    if len(out) < need:
                        out += row[i + 1:i + 1 + row[i]]
                    i += 1 + row[i]
        if len(out) < need:
            raise ValueError("MSP: not enough image data")
        raw = bytes(out[:need])
    return _bilevel(np.frombuffer(raw, np.uint8).reshape(h, stride), w)


# XbmImagePlugin's header, matched on the first 512 bytes
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
# XbmDecode.c's HEX(): a byte that is no hex digit counts 0
_HEX = np.array([int(chr(c), 16) if chr(c) in "0123456789abcdefABCDEF" else 0
                 for c in range(256)], np.uint8)


def _decode_xbm(data: bytes) -> np.ndarray:
    """X11 bitmap as PIL reads it: its header pattern on the first 512
    bytes; then, as XbmDecode.c, each value is the two bytes after the next
    `x`, least significant bit first."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("XBM: no XBM header")
    w, h = int(m.group("width")), int(m.group("height"))
    if w == 0 or h == 0:
        raise NotThisFormat("XBM: empty image")
    check_size("XBM", w, h)
    stride = (w + 7) // 8
    pairs = []
    for pair in re.finditer(rb"x([\s\S][\s\S])", data[m.end():]):
        pairs.append(pair.group(1))
        if len(pairs) == stride * h:
            break
    else:
        raise ValueError("XBM: truncated bitmap")
    digits = _HEX[np.frombuffer(b"".join(pairs), np.uint8)].reshape(-1, 2)
    values = (digits[:, 0] << 4) | digits[:, 1]
    return _bilevel(values.reshape(h, stride), w, lsb_first=True)


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


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool, kind: str) -> np.ndarray:
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
                raise ValueError(f"{kind}: truncated RLE delta")
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
        raise ValueError(f"{kind}: truncated RLE data")
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _decode_bmp(data: bytes) -> np.ndarray:
    """BMP as PIL's BmpImagePlugin reads it: the header kinds, bit depths,
    BITFIELDS layouts and RLE of its tables, and nothing else."""
    if len(data) < 18:
        raise ValueError("BMP: truncated header")
    try:
        return dib(data, 14, struct.unpack("<I", data[10:14])[0])[0]
    except NotThisFormat as e:     # no later plugin takes "BM": refused by name
        raise ValueError(str(e)) from None


def decode_dib(data: bytes) -> np.ndarray:
    """A headerless DIB (PIL's DIB plugin): the info header at byte 0, the
    pixels after it, its masks and its palette."""
    return dib(data, 0, 0)[0]


def dib(data: bytes, start: int, offset: int, kind: str = "BMP",
        halve: bool = False) -> Tuple[np.ndarray, int]:
    """BmpImageFile._bitmap: the info header at `start`, the pixels at
    `offset` or, where that is 0, after the header, its masks and its
    palette. `halve` keeps the top half of the rows, the XOR bitmap of an
    icon or a cursor entry. -> (RGB, the pixels' offset). Where PIL's reads
    would raise struct.error, NotThisFormat."""
    if len(data) < start + 4:
        raise NotThisFormat(f"{kind}: truncated header")
    hsize = struct.unpack("<I", data[start:start + 4])[0]
    hd = data[start + 4:start + hsize]
    if hsize < 12 or len(hd) < hsize - 4:
        raise ValueError(f"{kind}: truncated header")
    pos = start + hsize
    masks = None
    if hsize == 12:                     # OS/2 BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        compression, colors, pal_pad, bottom_up = 0, 0, 3, True
    elif hsize in _DIB_HEADERS:
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
                    raise NotThisFormat(f"{kind}: truncated header")
                masks = struct.unpack("<III", data[pos:pos + 12]) + (0,)
                pos += 12
    else:
        raise ValueError(f"{kind}: header size {hsize} is not one PIL reads")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{kind}: {bits} bits a pixel is not one PIL reads")
    if w == 0 or h == 0:
        raise NotThisFormat(f"{kind}: empty image")
    check_size(kind, w, h)
    if compression == 3:
        if bits == 32 and masks in _BMP_MASKS32:
            layout = _BMP_MASKS32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            layout = None
        elif bits == 16 and masks[:3] in _BMP_MASKS16:
            layout = _BMP_MASKS16[masks[:3]]
        else:
            raise ValueError(f"{kind}: BITFIELDS layout {masks} is not one PIL reads")
    elif compression == 0:
        layout = 5 if bits == 16 else (2, 1, 0) if bits == 32 else None
    elif compression in (1, 2):
        layout = None
    else:
        raise ValueError(f"{kind}: compression {compression} is not one PIL reads")

    palette, mode = None, "RGB"
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{kind}: palette of {colors} colours")
        raw = data[pos:pos + pal_pad * colors]
        pos += len(raw)
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

    offset = offset or pos
    if halve:
        h //= 2
        if h == 0:
            raise NotThisFormat(f"{kind}: empty image")
    if compression in (1, 2):
        idx = _bmp_rle(data, offset, w, h, compression == 2, kind)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if len(data) < offset + stride * h:
            raise ValueError(f"{kind}: truncated pixel data")
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
        rgb = np.repeat(np.where(idx[..., None] != 0, 255, 0).astype(np.uint8), 3, -1)
    elif mode == "L":
        rgb = np.repeat(np.ascontiguousarray(idx)[..., None], 3, -1)
    else:
        rgb = palette[idx] if mode == "P" else np.ascontiguousarray(idx)
    return rgb, offset


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
