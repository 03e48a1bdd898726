"""The port's TIFF decoder (data/tiff.py) against PIL (TiffImagePlugin and
libtiff), on the CPU, pixel for pixel: every compression the port reads
(none, PackBits, LZW, Deflate) at every photometric interpretation and bit
depth it reads (min-is-white and min-is-black at 1, 2, 4, 8 and 16 bits,
RGB at 8 and 16, palette at 1, 2, 4 and 8, CMYK), the horizontal
predictor at 8 and 16 bits, strips and tiles, planar configurations 1 and
2, both byte orders, BigTIFF, extra samples (associated alpha divided out
as PIL's "RGBa" does), FillOrder 2 and the eight orientations; files PIL
writes in every mode and compression; and, written by the small writer
below, what PIL does not write. Every refused variant raises a ValueError
that names it; truncated and corrupt files raise."""

import io
import lzma
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data.tiff import decode_tiff

H, W = 23, 37


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _same_as_pil(data):
    got = decode_tiff(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(codecs.decode(data), got)


def _samples(spp, bits, seed, high=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, high or (1 << bits), (H, W, spp))


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: codes most significant bit first, a clear code first, one
    bit wider once the next free code needs it (the decoder reads the
    change a code early), a clear code when the table is full."""
    codes, width = [(256, 9)], 9
    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""

    def added():
        nonlocal nxt, width
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
    for c in data:
        if w + bytes([c]) in table:
            w += bytes([c])
            continue
        codes.append((table[w], width))
        table[w + bytes([c])] = nxt
        added()
        if nxt >= 4094:
            codes.append((256, width))
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([c])
    if w:
        codes.append((table[w], width))
        added()
    codes.append((257, width))
    bits = "".join(format(code, f"0{n}b") for code, n in codes)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes, literals of up to 128."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run > 1:
            out += bytes([257 - run]) + data[i:i + 1]
        else:
            while (i + run < len(data) and run < 128
                   and not (i + run + 1 < len(data) and data[i + run + 1] == data[i + run])):
                run += 1
            out += bytes([run - 1]) + data[i:i + run]
        i += run
    return bytes(out)


def _pack_rows(px: np.ndarray, bits: int, bo: str, kind: str = "u") -> bytes:
    """(rows, cols, s) samples -> the rows' bytes, each row padded to a byte;
    `kind` u, i or f (SampleFormat 1, 2, 3) at 16 and 32 bits."""
    if bits in (16, 32, 64):
        return px.astype(f"{bo}{kind}{bits // 8}").tobytes()
    if bits == 8:
        return px.astype(np.uint8).tobytes()
    if bits == 12:
        rows = px.reshape(px.shape[0], -1).astype(np.int64)
        rows = np.pad(rows, ((0, 0), (0, rows.shape[1] % 2)))
        a, b = rows[:, 0::2], rows[:, 1::2]
        packed = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).reshape(
            rows.shape[0], -1)
        n = (px.shape[1] * px.shape[2] * 12 + 7) // 8
        return packed[:, :n].astype(np.uint8).tobytes()
    rows = px.reshape(px.shape[0], -1)
    rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % (8 // bits))))
    shifts = np.arange(8 - bits, -1, -bits)
    return (rows.reshape(rows.shape[0], -1, 8 // bits) << shifts).sum(-1).astype(np.uint8).tobytes()


_BIT_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _float_predict(row_bytes: bytes, n: int, spp: int, bo: str) -> bytes:
    """libtiff's floating-point predictor (3) on one row of n 4-byte samples:
    the samples' bytes regrouped into planes, most significant first, then
    differenced along the row with a stride of spp bytes."""
    b = np.frombuffer(row_bytes, np.uint8).reshape(n, 4)
    if bo == "<":
        b = b[:, ::-1]
    planes = b.T.reshape(-1).astype(np.int64)
    planes[spp:] = planes[spp:] - planes[:-spp]
    return (planes % 256).astype(np.uint8).tobytes()


def _tiff(samples, bits, photo, compression=1, predictor=1, planar=1, tile=None,
          rows_per_strip=None, bo="<", big=False, extra=(), colormap=None, fill=1,
          orientation=None, extra_tags=(), kind="u", chunks=None):
    """A TIFF of samples (h, w, spp) at `bits` bits (`kind` u, i or f):
    strips (all rows, or `rows_per_strip`) or tiles, chunky or planar,
    predicted and compressed as asked (bits reversed after compression for
    FillOrder 2), little- or big-endian, classic or BigTIFF; `chunks`, if
    given, the strips' or tiles' bytes as they are; `extra_tags` ({tag:
    (type, values)}, rationals as flat numerator, denominator pairs) last,
    over the others."""
    samples = np.asarray(samples)
    h, w, spp = samples.shape

    def chunk(px):
        if predictor == 2:
            px = np.concatenate([px[:, :1], np.diff(px.astype(np.int64), axis=1)], 1) % (1 << bits)
        data = _pack_rows(px, bits, bo, kind)
        if predictor == 3:
            n, rb = px.shape[1] * px.shape[2], len(data) // px.shape[0]
            data = b"".join(_float_predict(data[r * rb:(r + 1) * rb], n, px.shape[2], bo)
                            for r in range(px.shape[0]))
        raw = {1: bytes, 5: _lzw_encode, 8: zlib.compress, 32946: zlib.compress,
               32773: _packbits_encode, 34925: lzma.compress}[compression](data)
        return raw.translate(_BIT_REVERSE) if fill == 2 else raw

    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(spp)]
    given, chunks = chunks, []
    for pl in planes if given is None else ():
        if tile:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, pl.shape[2]), np.int64)
            padded[:h, :w] = pl
            chunks += [chunk(padded[y:y + th, x:x + tw]) for y in range(0, h, th)
                       for x in range(0, w, tw)]
        else:
            rps = rows_per_strip or h
            chunks += [chunk(pl[y:y + rps]) for y in range(0, h, rps)]
    chunks = chunks if given is None else list(given)
    blob, offsets = bytearray(16 if big else 8), []
    for c in chunks:
        offsets.append(len(blob))
        blob += c + b"\0" * (len(c) & 1)
    counts = [len(c) for c in chunks]
    long_ = 16 if big else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photo]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (long_, offsets),
                     325: (long_, counts)})
    else:
        tags.update({278: (4, [rows_per_strip or h]), 273: (long_, offsets),
                     279: (long_, counts)})
    for tag, on, value in ((266, fill != 1, [fill]), (317, predictor != 1, [predictor]),
                           (338, bool(extra), list(extra)),
                           (320, colormap is not None, [] if colormap is None else list(colormap)),
                           (274, bool(orientation), [orientation])):
        if on:
            tags[tag] = (3, value)
    tags.update(dict(extra_tags))
    fmt = {3: "H", 4: "I", 16: "Q", 5: "I", 7: "B"}
    word, inline = ("Q", 8) if big else ("I", 4)
    entries = sorted(tags.items())
    ifd_at = len(blob)
    data_at = ifd_at + (8 if big else 2) + (20 if big else 12) * len(entries) + inline
    ifd = bytearray(struct.pack(bo + ("Q" if big else "H"), len(entries)))
    arrays = bytearray()
    for tag, (type_, values) in entries:
        payload = struct.pack(bo + fmt[type_] * len(values), *values)
        count = len(values) // 2 if type_ == 5 else len(values)
        if len(payload) <= inline:
            value = payload.ljust(inline, b"\0")
        else:
            value = struct.pack(bo + word, data_at + len(arrays))
            arrays += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(bo + "HH" + word, tag, type_, count) + value
    blob += ifd + bytes(inline) + arrays
    magic = {("<", False): b"II*\0", (">", False): b"MM\0*", ("<", True): b"II+\0",
             (">", True): b"MM\0+"}[bo, big]
    blob[:16 if big else 8] = magic + (struct.pack(bo + "HHQ", 8, 0, ifd_at) if big
                                      else struct.pack(bo + "I", ifd_at))
    return bytes(blob)

_LAYOUTS = {   # (photometric, bits, samples a pixel, extra samples, colour map)
    "min-is-white 1": (0, 1, 1, ()), "min-is-white 8": (0, 8, 1, ()),
    "min-is-white 16": (0, 16, 1, ()), "min-is-black 1": (1, 1, 1, ()),
    "min-is-black 2": (1, 2, 1, ()), "min-is-black 4": (1, 4, 1, ()),
    "min-is-black 8": (1, 8, 1, ()), "min-is-black 16": (1, 16, 1, ()),
    "rgb 8": (2, 8, 3, ()), "rgb 16": (2, 16, 3, ()), "palette 1": (3, 1, 1, ()),
    "palette 2": (3, 2, 1, ()), "palette 4": (3, 4, 1, ()), "palette 8": (3, 8, 1, ()),
    "cmyk 8": (5, 8, 4, ()), "grey + alpha": (1, 8, 2, (2,)),
    "palette + alpha": (3, 8, 2, (2,)),
}


def _layout_tiff(name, seed, **kw):
    photo, bits, spp, extra = _LAYOUTS[name]
    high = 400 if bits == 16 and spp == 1 else None        # grey past 255: PIL clips
    cmap = np.random.default_rng(seed).integers(0, 65536, 3 << bits) if photo == 3 else None
    return _tiff(_samples(spp, bits, seed, high), bits, photo, extra=extra, colormap=cmap, **kw)


@pytest.mark.parametrize("compression", [1, 32773, 5, 8, 34925],
                         ids=["none", "packbits", "lzw", "deflate", "lzma"])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_every_compression_photometric_and_depth(layout, compression):
    _same_as_pil(_layout_tiff(layout, seed=compression, compression=compression,
                              rows_per_strip=7))


@pytest.mark.parametrize("compression", [5, 8, 32946], ids=["lzw", "deflate", "deflate-old"])
@pytest.mark.parametrize("layout", ["min-is-black 8", "min-is-black 16", "rgb 8", "rgb 16",
                                    "cmyk 8"])
def test_horizontal_predictor(layout, compression):
    _same_as_pil(_layout_tiff(layout, seed=3, compression=compression, predictor=2))


@pytest.mark.parametrize("compression", [1, 32773], ids=["none", "packbits"])
def test_predictor_tag_is_ignored_where_libtiff_ignores_it(compression):
    _same_as_pil(_layout_tiff("rgb 8", seed=4, compression=compression, predictor=2))


@pytest.mark.parametrize("compression", [1, 5, 8], ids=["none", "lzw", "deflate"])
@pytest.mark.parametrize("layout", ["rgb 8", "rgb 16", "cmyk 8", "palette 4"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)], ids=str)
def test_tiles(layout, compression, tile):
    _same_as_pil(_layout_tiff(layout, seed=5, compression=compression, tile=tile))


@pytest.mark.parametrize("compression", [5, 8, 32773], ids=["lzw", "deflate", "packbits"])
@pytest.mark.parametrize("case", ["rgb 8", "rgb 16", "cmyk 8", "rgba", "rgba associated",
                                  "rgb 8 tiles"])
def test_planar_configuration_2(case, compression):
    bits = 16 if case == "rgb 16" else 8
    extra = {"rgba": (2,), "rgba associated": (1,)}.get(case, ())
    spp = 4 if case.startswith(("cmyk", "rgba")) else 3
    _same_as_pil(_tiff(_samples(spp, bits, 6), bits, 5 if case == "cmyk 8" else 2,
                       compression=compression, planar=2, extra=extra, rows_per_strip=8,
                       tile=(16, 16) if case.endswith("tiles") else None))


def test_uncompressed_planar_8_bit():
    _same_as_pil(_tiff(_samples(3, 8, 7), 8, 2, planar=2, rows_per_strip=5))
    _same_as_pil(_tiff(_samples(4, 8, 7), 8, 2, planar=2, extra=(2,)))


@pytest.mark.parametrize("bits,extra", [(8, ()), (8, (0,)), (8, (1,)), (8, (2,)), (8, (0, 0)),
                                        (8, (1, 0)), (8, (2, 0, 0)), (16, (0,)), (16, (1,)),
                                        (16, (2,))], ids=str)
def test_extra_samples(bits, extra):
    """Unspecified and unassociated alpha are dropped; associated alpha is
    divided out first (v * 255 // a, zero where a is zero), as PIL's RGBa."""
    x = _samples(4 + len(extra) - 1, bits, 8) if extra else _samples(4, bits, 8)
    x[:5, :, 3] = 0                         # zero, full and (elsewhere) partial alpha
    x[5:9, :, 3] = (1 << bits) - 1
    _same_as_pil(_tiff(x, bits, 2, extra=extra, compression=8))


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", ["min-is-black 16", "rgb 16", "rgb 8", "palette 2"])
def test_byte_orders(layout, bo):
    _same_as_pil(_layout_tiff(layout, seed=9, bo=bo, compression=5, predictor=2
                              if _LAYOUTS[layout][1] >= 8 else 1))


@pytest.mark.parametrize("kw", [dict(compression=5, rows_per_strip=4), dict(tile=(16, 32)),
                                dict(compression=8, planar=2)], ids=["lzw", "tiles", "planar"])
def test_bigtiff(kw):
    _same_as_pil(_tiff(_samples(3, 8, 10), 8, 2, big=True, **kw))


@pytest.mark.parametrize("compression", [1, 32773, 5, 8, 34925],
                         ids=["none", "packbits", "lzw", "deflate", "lzma"])
@pytest.mark.parametrize("layout", ["min-is-black 2", "min-is-black 4", "min-is-black 8",
                                    "min-is-black 16", "palette 8", "rgb 8"])
def test_fill_order_2(layout, compression):
    """Bits reversed in each byte of the strips, where PIL reads them so
    (libtiff reverses them before it decompresses)."""
    _same_as_pil(_layout_tiff(layout, seed=11, compression=compression, fill=2))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_applied(orientation):
    _same_as_pil(_tiff(_samples(3, 8, 12), 8, 2, compression=8, orientation=orientation))


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "packbits",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1", "RGBA", "CMYK", "LA", "I;16"])
def test_files_pil_writes(mode, compression):
    rgb = _samples(3, 8, 13).astype(np.uint8)
    im = Image.fromarray(rgb)
    if mode == "I;16":
        im = Image.fromarray(rgb[..., 0].astype(np.uint16) * 3)
    elif mode == "RGBA":
        im = Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), "RGBA")
    else:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="TIFF", compression=compression)
    _same_as_pil(buf.getvalue())


# -- JPEG-in-TIFF, YCbCr, CIELab, sample formats, LZMA ------------------------------

SIZES = [(1, 1), (17, 23), (37, 29)]     # (h, w): 37 and 29 are no multiple of an MCU


def _photo_rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / 5.0 + yy / 9.0), 128 + 70 * np.cos(yy / 4.0),
                    (3 * xx + 2 * yy) % 256], -1) + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_tiff_of(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCbCr", "LAB"])
def test_jpeg_in_tiff_pil_writes(mode, size):
    """libtiff's JPEG codec: one JPEG stream a strip, its tables in the
    JPEGTables tag; YCbCr photometric decoded to RGB by libjpeg."""
    _same_as_pil(_pil_tiff_of(_photo_rgb(*size, seed=20), mode, compression="jpeg"))


_TABLE_MARKERS = (0xC4, 0xDB, 0xDD)


def _split_tables(jpeg: bytes):
    """A JPEG stream -> (tables-only stream, the stream without its DQT,
    DHT and DRI segments), as libtiff's JPEG codec writes them."""
    tables, rest, i = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while jpeg[i + 1] != 0xDA:
        n = int.from_bytes(jpeg[i + 2:i + 4], "big")
        seg = jpeg[i:i + 2 + n]
        (tables if jpeg[i + 1] in _TABLE_MARKERS else rest).extend(seg)
        i += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(rest + jpeg[i:])


def _jpeg_in_tiff(img, sub, layout, with_tables, quality=80, bo="<"):
    """A YCbCr JPEG-in-TIFF of RGB `img` (h, w, 3), every strip or tile a
    JPEG of PIL's encoder at chroma subsampling `sub` (h, v); the tables in
    JPEGTables (one set for all) or in every stream."""
    h, w, _ = img.shape
    subsampling = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[sub]
    tile = layout if isinstance(layout, tuple) else None
    rps = 16
    if tile:
        tw, th = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, 3), np.uint8)
        padded[:h, :w] = img
        pieces = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        pieces = [img[y:y + rps] for y in range(0, h, rps)]
    streams = []
    for piece in pieces:
        buf = io.BytesIO()
        Image.fromarray(piece).save(buf, format="JPEG", quality=quality, subsampling=subsampling)
        streams.append(buf.getvalue())
    tags = {530: (3, list(sub)), 532: (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])}
    if with_tables:
        parts = [_split_tables(x) for x in streams]
        streams = [rest for _, rest in parts]
        tags[347] = (7, list(parts[0][0]))
    return _tiff(np.zeros((h, w, 3)), 8, 6, compression=7, tile=tile, bo=bo,
                 rows_per_strip=None if tile else rps, chunks=streams,
                 extra_tags=tuple(tags.items()))


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("layout,with_tables", [("strips", True), ((16, 16), True),
                                                ("strips", False), ((32, 16), False)], ids=str)
@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 1)], ids=str)
def test_jpeg_in_tiff_ycbcr_subsampled(sub, layout, with_tables, size):
    _same_as_pil(_jpeg_in_tiff(_photo_rgb(*size, seed=21), sub, layout, with_tables))


def test_jpeg_in_tiff_big_endian():
    _same_as_pil(_jpeg_in_tiff(_photo_rgb(37, 29, seed=22), (2, 2), "strips", True, bo=">"))


def _ycbcr_samples(rgb):
    """JFIF's RGB -> YCbCr, rounded: (h, w, 3) uint8."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return np.clip(np.round(np.stack([y, (b - y) / 1.772 + 128, (r - y) / 1.402 + 128], -1)),
                   0, 255).astype(np.uint8)


def _ycbcr_blocks(ycc, sub, rows_per_strip):
    """TIFF's subsampled YCbCr layout, one strip of rows at a time: blocks of
    h x v luma samples (edge samples replicated past the image) then one Cb
    and one Cr (the block's first), left to right, top to bottom."""
    hs, vs = sub
    out = []
    for y0 in range(0, ycc.shape[0], rows_per_strip):
        part = ycc[y0:y0 + rows_per_strip]
        ph, pw = -(-part.shape[0] // vs) * vs, -(-part.shape[1] // hs) * hs
        part = np.pad(part, ((0, ph - part.shape[0]), (0, pw - part.shape[1]), (0, 0)), "edge")
        bh, bw = ph // vs, pw // hs
        lum = part[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, -1)
        out.append(np.concatenate([lum, part[::vs, ::hs, 1:]], -1).astype(np.uint8).tobytes())
    return out


_YCC_COMPRESS = {5: _lzw_encode, 8: zlib.compress, 32773: _packbits_encode,
                 34925: lzma.compress}


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)],
                         ids=str)
@pytest.mark.parametrize("compression", [5, 8, 32773], ids=["lzw", "deflate", "packbits"])
def test_ycbcr_photometric(compression, sub, size):
    """libtiff's RGBA interface (PIL reads YCbCr other than JPEG through it):
    chroma replicated over its block, libtiff's fixed-point tables."""
    ycc = _ycbcr_samples(_photo_rgb(*size, seed=23))
    rps = 8
    chunks = [_YCC_COMPRESS[compression](c) for c in _ycbcr_blocks(ycc, sub, rps)]
    _same_as_pil(_tiff(ycc, 8, 6, compression=compression, rows_per_strip=rps, chunks=chunks,
                       extra_tags=((530, (3, list(sub))),)))


@pytest.mark.parametrize("tags", [
    ((532, (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])),),           # studio range
    ((529, (5, [2126, 10000, 7152, 10000, 722, 10000])),),                      # BT.709
    ((529, (5, [299, 1000, 587, 1000, 114, 1000])),
     (532, (5, [15, 1, 236, 1, 127, 2, 511, 2, 129, 1, 254, 1]))),
], ids=["reference black white", "coefficients", "both"])
def test_ycbcr_coefficients_and_reference_black_white(tags):
    ycc = _ycbcr_samples(_photo_rgb(37, 29, seed=24))
    chunks = [zlib.compress(c) for c in _ycbcr_blocks(ycc, (2, 2), 16)]
    _same_as_pil(_tiff(ycc, 8, 6, compression=8, rows_per_strip=16, chunks=chunks,
                       extra_tags=((530, (3, [2, 2])),) + tags))


@pytest.mark.parametrize("kw", [dict(tile=(16, 16)), dict(planar=2), dict(predictor=2)],
                         ids=["tiles", "planar", "predictor"])
def test_ycbcr_unsubsampled_layouts(kw):
    ycc = _ycbcr_samples(_photo_rgb(37, 29, seed=25))
    _same_as_pil(_tiff(ycc, 8, 6, compression=5, extra_tags=((530, (3, [1, 1])),), **kw))


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "jpeg"])
def test_cielab(compression, size):
    """PIL's LAB -> RGB goes through LittleCMS; the port emulates its CLUT."""
    _same_as_pil(_pil_tiff_of(_photo_rgb(*size, seed=26), "LAB", compression=compression))


def test_cielab_every_value():
    """All 2 ** 24 Lab samples would take a minute; every L, a and b value
    along with a seeded sample of the rest."""
    rng = np.random.default_rng(27)
    v = np.arange(256)
    lab = np.concatenate([np.stack([v, v, v], -1), np.stack([v, 255 - v, (v * 7) % 256], -1),
                          rng.integers(0, 256, (60 * 256, 3))]).astype(np.uint8)
    _same_as_pil(_tiff(lab.reshape(62, 256, 3), 8, 8, compression=8))


def _float_samples(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 120, (h, w, 1)).astype(np.float32)
    x.flat[:6] = [np.nan, np.inf, -np.inf, 254.999, -0.5, 255.5][:x.size]
    return x


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression,predictor", [(1, 1), (5, 1), (8, 3), (5, 3), (34925, 1),
                                                   (8, 2)], ids=str)
@pytest.mark.parametrize("photo", [0, 1])
def test_float_samples(photo, compression, predictor, bo):
    """PIL's F: clipped to 0..255 and truncated, NaN 0; min-is-white is not
    inverted; big-endian samples through libtiff as PIL unpacks them."""
    x = _float_samples(23, 17, seed=28)
    if predictor == 2:
        x = np.round(np.abs(np.nan_to_num(x)))
    xs = x.view(np.uint32) if predictor == 2 else x
    _same_as_pil(_tiff(xs, 32, photo, compression=compression, predictor=predictor, bo=bo,
                       kind="u" if predictor == 2 else "f", rows_per_strip=8,
                       extra_tags=((339, (3, [3])),)))


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 8], ids=["none", "lzw", "deflate"])
@pytest.mark.parametrize("bits,fmt", [(8, 2), (16, 2), (32, 2), (32, 1)], ids=str)
def test_integer_sample_formats(bits, fmt, compression, bo):
    """Signed 8 bits read as unsigned (PIL's L); signed 16 and 32 and
    unsigned 32 (little-endian only, read as signed) as PIL's I, clipped."""
    rng = np.random.default_rng(29)
    x = rng.integers(-400, 700, (19, 23, 1)) if fmt == 2 else rng.integers(0, 1 << 32, (19, 23, 1))
    x = x % 256 if bits == 8 else x
    data = _tiff(x, bits, 1, compression=compression, bo=bo, kind="i" if fmt == 2 else "u",
                 extra_tags=((339, (3, [fmt])),))
    if fmt == 1 and bo == ">":
        with pytest.raises(ValueError, match="refused by PIL too"):
            decode_tiff(data)
        return
    _same_as_pil(data)


@pytest.mark.parametrize("compression,predictor", [(1, 1), (5, 1), (8, 2), (5, 2)], ids=str)
def test_32_bit_predictor_and_12_bit_grey(compression, predictor):
    rng = np.random.default_rng(30)
    x = rng.integers(-300, 600, (21, 19, 1))
    _same_as_pil(_tiff(x, 32, 1, compression=compression, predictor=predictor, kind="i",
                       extra_tags=((339, (3, [2])),)))
    if predictor == 1:
        _same_as_pil(_tiff(rng.integers(0, 4096, (21, 19, 1)), 12, 1, compression=compression))


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 8, 34925], ids=["none", "lzw", "deflate", "lzma"])
def test_16_bit_cmyk(compression, bo):
    _same_as_pil(_tiff(_samples(4, 16, 31), 16, 5, compression=compression, bo=bo,
                       predictor=2 if compression == 5 else 1))


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("kind", ["float", "signed 16", "signed 32", "12-bit", "cmyk 16",
                                  "lzma rgb"])
def test_sample_formats_and_lzma_at_every_size(kind, size):
    rng = np.random.default_rng(37)
    h, w = size
    if kind == "float":
        data = _tiff(_float_samples(h, w, 37), 32, 1, compression=8, kind="f",
                     extra_tags=((339, (3, [3])),))
    elif kind.startswith("signed"):
        bits = int(kind.split()[1])
        data = _tiff(rng.integers(-300, 600, (h, w, 1)), bits, 1, compression=5, kind="i",
                     bo=">", extra_tags=((339, (3, [2])),))
    elif kind == "12-bit":
        data = _tiff(rng.integers(0, 4096, (h, w, 1)), 12, 1, compression=8)
    elif kind == "cmyk 16":
        data = _tiff(rng.integers(0, 65536, (h, w, 4)), 16, 5, compression=34925)
    else:
        data = _tiff(rng.integers(0, 256, (h, w, 3)), 8, 2, compression=34925, predictor=2)
    _same_as_pil(data)


@pytest.mark.parametrize("mode", ["RGB", "L", "1", "P", "CMYK", "YCbCr", "LAB", "F", "I"])
def test_lzma_files_pil_writes(mode):
    img = _photo_rgb(23, 37, seed=32)
    if mode in ("F", "I"):
        im = Image.fromarray(img[..., 0].astype(np.float32 if mode == "F" else np.int32) * 1.5
                             - 40 if mode == "F" else img[..., 0].astype(np.int32) * 2 - 60)
        buf = io.BytesIO()
        im.save(buf, format="TIFF", compression="lzma")
        data = buf.getvalue()
    else:
        data = _pil_tiff_of(img, mode, compression="lzma")
    _same_as_pil(data)


def _fax_image(h, w, seed):
    """Bilevel rows of runs from 1 to a few thousand pixels: every
    terminating, make-up and extended make-up code, both colours."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(h):
        row, c = [], int(rng.integers(0, 2))
        while len(row) < w:
            n = int(rng.choice([rng.integers(1, 8), rng.integers(1, 70), rng.integers(60, 2700)]))
            row += [c] * n
            c ^= 1
        rows.append(row[:w])
    return np.array(rows, bool)


_FAX_WRITES = {"group 4": ("group4", {}), "group 3, 1d": ("group3", {}),
               "group 3, 2d": ("group3", {292: 1}), "group 3, 2d, fill bits": ("group3", {292: 5}),
               "group 3, 1d, fill bits": ("group3", {292: 4}),
               "modified huffman": ("tiff_ccitt", {}), "group 4, fill order 2": ("group4", {266: 2}),
               "group 3, 2d, fill order 2": ("group3", {292: 1, 266: 2})}


@pytest.mark.parametrize("size", SIZES + [(9, 2700)], ids=str)
@pytest.mark.parametrize("kind", list(_FAX_WRITES))
def test_ccitt_files_pil_writes(kind, size):
    """libtiff's fax codecs through PIL: Modified Huffman (2), T.4 one- and
    two-dimensional with and without fill bits (3), T.6 (4), FillOrder 2."""
    compression, info = _FAX_WRITES[kind]
    img = _fax_image(*size, seed=size[1]) if size[1] > 100 else (
        np.random.default_rng(33).random(size) < 0.4)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF", compression=compression, tiffinfo=info)
    _same_as_pil(buf.getvalue())


@pytest.mark.parametrize("photo", [0, 1])
@pytest.mark.parametrize("kw", [dict(rows_per_strip=5), dict(tile=(16, 16))], ids=str)
def test_ccitt_strips_tiles_and_photometric(photo, kw):
    """Each strip or tile starts against a white row; min-is-white and
    min-is-black read the same bits as PIL's 1;I and 1."""
    img = np.random.default_rng(34).random((37, 29)) < 0.3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF", compression="group4")
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        pieces = _fax_pieces(im, img, kw)
    _same_as_pil(_tiff(img[..., None].astype(np.uint8), 1, photo, chunks=pieces,
                       extra_tags=((259, (3, [4])),), **kw))


def _fax_pieces(im, img, kw):
    """T.6 data of each strip or tile of img, each written by libtiff alone."""
    tile = kw.get("tile")
    h, w = img.shape
    if tile:
        tw, th = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw), bool)
        padded[:h, :w] = img
        parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        parts = [img[y:y + kw["rows_per_strip"]] for y in range(0, h, kw["rows_per_strip"])]
    out = []
    for part in parts:
        buf = io.BytesIO()
        Image.fromarray(part).save(buf, format="TIFF", compression="group4")
        with Image.open(io.BytesIO(buf.getvalue())) as one:
            off, n = one.tag_v2[273][0], one.tag_v2[279][0]
        out.append(buf.getvalue()[off:off + n])
    return out


def test_ccitt_cut_short_or_corrupt_raises():
    img = np.random.default_rng(35).random((37, 29)) < 0.3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF", compression="group4")
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    with pytest.raises(ValueError, match="CCITT"):
        decode_tiff(data[:off] + data[off:off + n // 3] + bytes(n - n // 3) + data[off + n:])
    with pytest.raises(ValueError, match="CCITT"):
        decode_tiff(data[:off] + b"\x02\x00" + data[off + 2:])   # the extension code


def _zstd_images(h, w, seed):
    """Noise (Huffman literals), smooth ramps (FSE-coded sequences, repeat
    offsets), a constant (RLE blocks) and a mix, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([yy * 3 + xx, xx * 2, (yy * xx) % 256], -1)
    return {"noise": rng.integers(0, 256, (h, w, 3)), "smooth": smooth,
            "mixed": smooth + rng.integers(0, 4, (h, w, 3)) * (rng.random((h, w, 1)) < .3),
            "constant": np.full((h, w, 3), 77)}


@pytest.mark.parametrize("kind", ["noise", "smooth", "mixed", "constant"])
@pytest.mark.parametrize("size", SIZES + [(300, 400)], ids=str)
@pytest.mark.parametrize("mode,predictor", [("RGB", 1), ("RGB", 2), ("L", 2), ("1", 1)],
                         ids=str)
def test_zstd_files_pil_writes(mode, predictor, size, kind):
    """libtiff's Zstd codec through PIL: the port's RFC 8878 decoder."""
    img = Image.fromarray(_zstd_images(*size, seed=size[0])[kind].astype(np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="TIFF", compression="zstd",
             tiffinfo={317: predictor} if predictor != 1 else {})
    _same_as_pil(buf.getvalue())


def test_zstd_cut_short_or_corrupt_raises():
    buf = io.BytesIO()
    Image.fromarray(_zstd_images(37, 29, seed=5)["mixed"].astype(np.uint8)).save(
        buf, format="TIFF", compression="zstd")
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    for bad in (data[off:off + n // 2], b"\x28\xb5\x2f\xfe" + data[off + 4:off + n],
                data[off:off + 4] + bytes([data[off + 4] | 8]) + data[off + 5:off + n]):
        with pytest.raises(ValueError, match="Zstd"):
            decode_tiff(data[:off] + bad + bytes(n - len(bad)) + data[off + n:])


# -- refusals ---------------------------------------------------------------------

def _pil_tiff(mode, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(_samples(3, 8, 14).astype(np.uint8))
    im = {"F": Image.fromarray(np.zeros((H, W), np.float32)), "I": im.convert("I"),
          "YCbCr": im.convert("YCbCr")}.get(mode, im.convert(mode) if mode != "RGB" else im)
    im.save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _jpeg_strip_past():
    """A 16x16 YCbCr JPEG-in-TIFF whose one strip is a 64x48 JPEG."""
    buf = io.BytesIO()
    Image.fromarray(_photo_rgb(48, 64, seed=36)).save(buf, format="JPEG", quality=80)
    return _tiff(np.zeros((16, 16, 3)), 8, 6, compression=7, chunks=[buf.getvalue()],
                 extra_tags=((530, (3, [2, 2])),))


def _refused():
    x8 = _samples(3, 8, 15)
    ycc = _ycbcr_samples(x8.astype(np.uint8))
    return {
        "ccitt at 8 bits": (_tiff(x8[..., :1], 8, 0, extra_tags=((259, (3, [4])),)),
                            "CCITT data of"),
        "ccitt rgb": (_tiff(x8, 8, 2, extra_tags=((259, (3, [3])),)), "CCITT data of"),
        "webp in tiff": (_tiff(x8, 8, 2, extra_tags=((259, (3, [50001])),)), "WebP"),
        "old-style jpeg": (_tiff(x8, 8, 6, extra_tags=((259, (3, [6])),)), "old-style JPEG"),
        "uncompressed ycbcr": (_tiff(ycc, 8, 6, extra_tags=((530, (3, [1, 1])),)),
                               "uncompressed YCbCr"),
        "ycbcr subsampling 2x4": (_tiff(ycc, 8, 6, compression=5,
                                        extra_tags=((530, (3, [2, 4])),)), "subsampling"),
        "64-bit float": (_tiff(_samples(1, 8, 15).astype(np.float64), 64, 1, kind="f",
                               extra_tags=((339, (3, [3])),)), "SampleFormat"),
        "signed min-is-white": (_tiff(_samples(1, 16, 15), 16, 0, kind="i",
                                      extra_tags=((339, (3, [2])),)), "SampleFormat"),
        "12-bit big-endian grey": (_tiff(_samples(1, 12, 15), 12, 1, bo=">"), "unknown pixel"),
        "jpeg-in-tiff 16-bit": (_tiff(_samples(3, 16, 15), 16, 2,
                                      extra_tags=((259, (3, [7])),)), "JPEG-in-TIFF at 16"),
        "jpeg strip past its strip": (_jpeg_strip_past(), "past its"),
        "unknown compression": (_tiff(x8, 8, 2, extra_tags=((259, (3, [40000])),)),
                                "compression 40000"),
        "float predictor on integers": (_tiff(x8, 8, 2, compression=8,
                                              extra_tags=((317, (3, [3])),)),
                                        "floating-point predictor"),
        "big-endian bigtiff": (_tiff(x8, 8, 2, big=True, bo=">"), "big-endian BigTIFF"),
        "planar extra sample 0": (_tiff(_samples(4, 8, 15), 8, 2, planar=2, extra=(0,),
                                        compression=8), "extra sample 0"),
        "uncompressed planar 16": (_tiff(_samples(3, 16, 15), 16, 2, planar=2),
                                   "16-bit planar"),
        "unknown layout": (_tiff(_samples(2, 8, 15), 8, 2), "unknown pixel mode"),
        "fill order 2, cmyk": (_tiff(_samples(4, 8, 15), 8, 5, compression=5, fill=2),
                               "unknown pixel mode"),
        "fill order 2, min-is-white 8": (_tiff(x8[..., :1], 8, 0, fill=2), "FillOrder 2"),
        "fill order 2, palette 4": (_tiff(x8[..., :1] % 16, 4, 3, fill=2, colormap=range(48)),
                                    "FillOrder 2"),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_refused_variants_are_named(case):
    """Each refusal names the variant; where it says PIL refuses it too,
    PIL does."""
    data, match = _refused()[case]
    with pytest.raises(ValueError, match=match) as e:
        decode_tiff(data)
    with pytest.raises(ValueError, match=match):
        codecs.decode(data)
    if "refused by PIL too" in str(e.value) or "refused by libtiff too" in str(e.value):
        with pytest.raises(Exception):
            _pil_rgb(data)


@pytest.mark.parametrize("compression", [1, 32773, 5, 8], ids=["none", "packbits", "lzw",
                                                                 "deflate"])
@pytest.mark.parametrize("cut", [0.3, 0.7, 0.97])
def test_a_file_cut_short_raises(compression, cut):
    """The strips come first in these files, then the IFD: cut anywhere, the
    IFD or the data it points to is gone."""
    data = _tiff(_samples(3, 8, 16), 8, 2, compression=compression)
    with pytest.raises(ValueError):
        decode_tiff(data[:int(len(data) * cut)])


def test_corrupt_data_raises():
    data = bytearray(_tiff(_samples(3, 8, 17), 8, 2, compression=8))
    data[8:12] = b"\xde\xad\xbe\xef"                          # the Deflate stream
    with pytest.raises(ValueError):
        decode_tiff(bytes(data))
    with pytest.raises(ValueError):
        decode_tiff(b"II*\x00\xff\xff\xff\x00")
    with pytest.raises(ValueError):
        decode_tiff(b"MM\x00*\x00\x00\x00\x08\x00\x01\x01\x00")
