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


def _pack_rows(px: np.ndarray, bits: int, bo: str) -> bytes:
    """(rows, cols, s) samples -> the rows' bytes, each row padded to a byte."""
    if bits == 16:
        return px.astype(bo + "u2").tobytes()
    if bits == 8:
        return px.astype(np.uint8).tobytes()
    rows = px.reshape(px.shape[0], -1)
    rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % (8 // bits))))
    shifts = np.arange(8 - bits, -1, -bits)
    return (rows.reshape(rows.shape[0], -1, 8 // bits) << shifts).sum(-1).astype(np.uint8).tobytes()


_BIT_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff(samples, bits, photo, compression=1, predictor=1, planar=1, tile=None,
          rows_per_strip=None, bo="<", big=False, extra=(), colormap=None, fill=1,
          orientation=None, extra_tags=()):
    """A TIFF of samples (h, w, spp) at `bits` bits: strips (all rows, or
    `rows_per_strip`) or tiles, chunky or planar, predicted and compressed
    as asked (bits reversed after compression for FillOrder 2), little- or
    big-endian, classic or BigTIFF; `extra_tags` ({tag: (type, values)})
    last, over the others."""
    samples = np.asarray(samples)
    h, w, spp = samples.shape

    def chunk(px):
        if predictor == 2:
            px = np.concatenate([px[:, :1], np.diff(px.astype(np.int64), axis=1)], 1) % (1 << bits)
        raw = {1: bytes, 5: _lzw_encode, 8: zlib.compress, 32946: zlib.compress,
               32773: _packbits_encode}[compression](_pack_rows(px, bits, bo))
        return raw.translate(_BIT_REVERSE) if fill == 2 else raw

    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(spp)]
    chunks = []
    for pl in planes:
        if tile:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, pl.shape[2]), np.int64)
            padded[:h, :w] = pl
            chunks += [chunk(padded[y:y + th, x:x + tw]) for y in range(0, h, th)
                       for x in range(0, w, tw)]
        else:
            rps = rows_per_strip or h
            chunks += [chunk(pl[y:y + rps]) for y in range(0, h, rps)]
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
    fmt = {3: "H", 4: "I", 16: "Q"}
    word, inline = ("Q", 8) if big else ("I", 4)
    entries = sorted(tags.items())
    ifd_at = len(blob)
    data_at = ifd_at + (8 if big else 2) + (20 if big else 12) * len(entries) + inline
    ifd = bytearray(struct.pack(bo + ("Q" if big else "H"), len(entries)))
    arrays = bytearray()
    for tag, (kind, values) in entries:
        payload = struct.pack(bo + fmt[kind] * len(values), *values)
        if len(payload) <= inline:
            value = payload.ljust(inline, b"\0")
        else:
            value = struct.pack(bo + word, data_at + len(arrays))
            arrays += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(bo + "HH" + word, tag, kind, len(values)) + value
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


@pytest.mark.parametrize("compression", [1, 32773, 5, 8], ids=["none", "packbits", "lzw",
                                                                 "deflate"])
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


@pytest.mark.parametrize("compression", [1, 32773], ids=["none", "packbits"])
@pytest.mark.parametrize("layout", ["min-is-black 2", "min-is-black 4", "min-is-black 8",
                                    "min-is-black 16", "palette 8", "rgb 8"])
def test_fill_order_2(layout, compression):
    """Bits reversed in each byte of the strips, where PIL reads them so."""
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


# -- refusals ---------------------------------------------------------------------

def _pil_tiff(mode, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(_samples(3, 8, 14).astype(np.uint8))
    im = {"F": Image.fromarray(np.zeros((H, W), np.float32)), "I": im.convert("I"),
          "YCbCr": im.convert("YCbCr")}.get(mode, im.convert(mode) if mode != "RGB" else im)
    im.save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _refused():
    x8 = _samples(3, 8, 15)
    return {
        "jpeg-in-tiff": (_pil_tiff("RGB", compression="jpeg"), "JPEG-in-TIFF"),
        "ccitt group 4": (_pil_tiff("1", compression="group4"), "CCITT Group 4"),
        "ccitt group 3": (_pil_tiff("1", compression="group3"), "CCITT Group 3"),
        "float samples": (_pil_tiff("F"), "float samples"),
        "signed samples": (_pil_tiff("I"), "signed samples"),
        "ycbcr": (_tiff(x8, 8, 6), "YCbCr"),
        "cielab": (_tiff(x8, 8, 8), "CIELab"),
        "12-bit grey": (_tiff(_samples(1, 16, 15, 4096), 16, 1, extra_tags=((258, (3, [12])),)),
                        "12-bit"),
        "16-bit cmyk": (_tiff(_samples(4, 16, 15), 16, 5), "16-bit CMYK"),
        "lzma": (_tiff(x8, 8, 2, extra_tags=((259, (3, [34925])),)), "LZMA"),
        "unknown compression": (_tiff(x8, 8, 2, extra_tags=((259, (3, [40000])),)),
                                "compression 40000"),
        "float predictor": (_tiff(x8, 8, 2, compression=8, extra_tags=((317, (3, [3])),)),
                            "floating-point predictor"),
        "big-endian bigtiff": (_tiff(x8, 8, 2, big=True, bo=">"), "big-endian BigTIFF"),
        "planar extra sample 0": (_tiff(_samples(4, 8, 15), 8, 2, planar=2, extra=(0,),
                                        compression=8), "extra sample 0"),
        "uncompressed planar 16": (_tiff(_samples(3, 16, 15), 16, 2, planar=2),
                                   "16-bit planar"),
        "unknown layout": (_tiff(_samples(2, 8, 15), 8, 2), "unknown pixel mode"),
        "fill order 2, lzw": (_tiff(x8, 8, 2, compression=5, fill=2), "FillOrder 2"),
        "fill order 2, min-is-white 8": (_tiff(x8[..., :1], 8, 0, fill=2), "FillOrder 2"),
        "fill order 2, palette 4": (_tiff(x8[..., :1] % 16, 4, 3, fill=2, colormap=range(48)),
                                    "FillOrder 2"),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_refused_variants_are_named(case):
    data, match = _refused()[case]
    with pytest.raises(ValueError, match=match):
        decode_tiff(data)
    with pytest.raises(ValueError, match=match):
        codecs.decode(data)


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
