"""The port's image codecs (data/codecs.py, data/gif.py) and loader
(data/loader.py) against PIL and the JAX package's loader, on the CPU:
decoded pixels equal PIL's `convert("RGB")` for every PNG colour type with
every row filter, 16-bit and Adam7-interlaced PNGs, PPM and PGM at every
maxval, plain P3 and P2 and bilevel P1 and P4, the BMP variants PIL reads
and GIF; `decode_resize` equals JAX's (Pillow's BILINEAR) exactly at up-
and downscales, on WebP, TIFF, CMYK JPEG and ASCII PNM files too; a P3 tree
loads as JAX's does; PNGs the port writes read back under PIL; formats PIL
opens and the port does not are refused by name; what neither decodes, and
input that is truncated or corrupt, raises ValueError. (JPEG, WebP and
TIFF have files of their own: test_torch_jpeg.py, test_torch_webp.py,
test_torch_tiff.py.)"""

import io
import os
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.config import DataConfig as JDataConfig
from shmgan_tpu.data.loader import PolarimetricDataset as JPolarimetricDataset
from shmgan_tpu.data.loader import decode_original as j_decode_original
from shmgan_tpu.data.loader import decode_resize as j_decode_resize
from shmgan_tpu.data.loader import list_images as j_list_images
from shmgan_tpu_torch.config import DataConfig
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data.loader import (PolarimetricDataset, decode_original, decode_resize,
                                          list_images)


def _photo(h, w, seed=0):
    """A smooth, noisy uint8 RGB image (every row filter finds work)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0), 128 + 80 * np.cos(yy / 5.0),
                    (2 * xx + yy) % 256], -1) + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered_png(px, ctype, palette=None, interlace=0, depth=8):
    """An 8-bit PNG of samples `px` (h, w, channels), row r filtered with
    filter r % 5, so that every filter type is used."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int32)
    raw = []
    for r in range(h):
        x = rows[r]
        up = rows[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][r % 5]
        raw.append(bytes([r % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(b"".join(raw))) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_every_colour_type_every_filter(ctype):
    img = _photo(23, 37, seed=ctype)
    palette = None
    if ctype == 3:
        palette = np.random.default_rng(1).integers(0, 256, (200, 3), np.uint8)
        px = (img[..., :1].astype(np.int32) * 199 // 255).astype(np.uint8)
    else:
        alpha = img[..., 2:3] ^ 0x5A
        px = {0: img[..., :1], 2: img, 4: np.concatenate([img[..., :1], alpha], -1),
              6: np.concatenate([img, alpha], -1)}[ctype]
    data = _filtered_png(px, ctype, palette)
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "P4", "1", "L2"])
def test_png_written_by_pil(mode):
    img = Image.fromarray(_photo(41, 29, seed=2))
    if mode == "P":
        img = img.quantize(60)
    elif mode == "P4":
        img = img.quantize(3)          # PIL packs a 3-colour palette at 2 bits
    elif mode == "L2":
        img = img.convert("L").point(lambda v: v // 85 * 85)
        data = _pil_bytes(img, "PNG", bits=2)
    elif mode in ("RGBA", "LA"):
        img = img.convert(mode)
    else:
        img = img.convert(mode)
    if mode != "L2":
        data = _pil_bytes(img, "PNG")
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("fmt,mode", [("PPM", "RGB"), ("PPM", "L"), ("BMP", "RGB")])
def test_ppm_pgm_bmp(fmt, mode):
    data = _pil_bytes(Image.fromarray(_photo(19, 26, seed=3)).convert(mode), fmt)
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_pnm_comments_and_maxval():
    px = np.random.default_rng(4).integers(0, 101, (5, 7, 3), np.uint8)
    data = b"P6\n# made by hand\n7 5\n# maxval next\n100\n" + px.tobytes()
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_top_down_bmp():
    img = _photo(6, 5, seed=5)
    bottom_up = _pil_bytes(Image.fromarray(img), "BMP")
    offset = struct.unpack("<I", bottom_up[10:14])[0]
    stride = (5 * 3 + 3) // 4 * 4
    rows = [bottom_up[offset + i * stride:offset + (i + 1) * stride] for i in range(6)]
    top_down = bytearray(bottom_up[:offset] + b"".join(rows[::-1]))
    top_down[22:26] = struct.pack("<i", -6)
    np.testing.assert_array_equal(codecs.decode(bytes(top_down)), img)


@pytest.mark.parametrize("size", [(8, 8), (20, 20), (33, 17), (64, 64), (97, 131), (200, 150)])
def test_resize_is_pillows_bilinear(size):
    img = _photo(97, 131, seed=6)
    want = np.asarray(Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR))
    np.testing.assert_array_equal(codecs.resize_bilinear(img, size), want)


@pytest.mark.parametrize("fmt,ext", [("PNG", "png"), ("PPM", "ppm"), ("BMP", "bmp")])
@pytest.mark.parametrize("image_size", [16, 48, 128])
def test_decode_resize_and_original_equal_jax(tmp_path, fmt, ext, image_size):
    path = str(tmp_path / f"img.{ext}")
    Image.fromarray(_photo(45, 61, seed=7)).save(path, format=fmt)
    got, want = decode_resize(path, image_size), j_decode_resize(path, image_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


def _variant_body(kind):
    """One file of each TIFF and JPEG variant the port reads beyond
    baseline, from the writers of test_torch_tiff.py and test_torch_jpeg.py."""
    import test_torch_jpeg as tj
    import test_torch_tiff as tt

    img = _photo(45, 61, seed=7)
    if kind == "arithmetic jpeg":
        return tj.arith_version(_pil_bytes(Image.fromarray(img), "JPEG", quality=85))
    if kind == "progressive arithmetic jpeg":
        return tj.arith_version(_pil_bytes(Image.fromarray(img), "JPEG", quality=85),
                                progressive=True)
    if kind == "lossless jpeg":
        return tj._lossless_jpeg(img, 4)
    if kind == "ycbcr jpeg-in-tiff":
        return tt._jpeg_in_tiff(img, (2, 2), "strips", True)
    if kind == "ycbcr lzw tiff":
        ycc = tt._ycbcr_samples(img)
        return tt._tiff(ycc, 8, 6, compression=5, rows_per_strip=8,
                        chunks=[tt._lzw_encode(c) for c in tt._ycbcr_blocks(ycc, (2, 2), 8)],
                        extra_tags=((530, (3, [2, 2])),))
    mode, compression = {"float tiff": ("F", "tiff_lzw"), "signed tiff": ("I", "tiff_lzw"),
                         "lzma tiff": ("RGB", "lzma"), "cielab tiff": ("LAB", "tiff_lzw")}[kind]
    im = Image.fromarray(img)
    if mode in ("F", "I"):
        im = Image.fromarray(img[..., 1].astype(np.float32 if mode == "F" else np.int32) * 2 - 70)
    return _pil_bytes(im.convert(mode) if mode == "LAB" else im, "TIFF", compression=compression)


_VARIANTS = ["arithmetic jpeg", "progressive arithmetic jpeg", "lossless jpeg",
             "ycbcr jpeg-in-tiff", "ycbcr lzw tiff", "float tiff", "signed tiff", "lzma tiff",
             "cielab tiff"]


@pytest.mark.parametrize("kind", _VARIANTS)
@pytest.mark.parametrize("image_size", [48, 128])
def test_decode_resize_and_original_equal_jax_on_tiff_and_jpeg_variants(tmp_path, kind,
                                                                          image_size):
    path = str(tmp_path / "img.png")     # a file is decoded by its bytes, never its name
    with open(path, "wb") as f:
        f.write(_variant_body(kind))
    got, want = decode_resize(path, image_size), j_decode_resize(path, image_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


@pytest.mark.parametrize("shape", [(17, 23, 3), (17, 23), (17, 23, 1), (1, 1, 3)])
def test_encode_png_reads_back_under_pil(shape):
    img = np.random.default_rng(8).integers(0, 256, shape, np.uint8)
    data = codecs.encode_png(img)
    with Image.open(io.BytesIO(data)) as im:
        got = np.asarray(im)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    np.testing.assert_array_equal(codecs.decode(data)[..., 0], img.reshape(shape[:2] + (-1,))[..., 0])


def _formerly_refused():
    """The inputs the port refused before it read JPEG, GIF, 16-bit and
    interlaced PNG, 16-bit PNM and palette BMP."""
    img = Image.fromarray(_photo(16, 16, seed=9))
    return {
        "jpeg": _pil_bytes(img, "JPEG"),
        "gif": _pil_bytes(img, "GIF"),
        "16-bit png": _pil_bytes(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                                                 * 1000), "PNG"),
        "interlaced png": _png(_photo(11, 13, seed=9), 2, 8, interlace=1),
        "16-bit ppm": b"P6\n2 2\n65535\n" + bytes(range(0, 240, 10)),
        "8-bit bmp": _pil_bytes(img.convert("L"), "BMP"),
        "cmyk jpeg": _pil_bytes(img.convert("CMYK"), "JPEG"),
        "lossy webp": _pil_bytes(img, "WEBP", quality=80),
        "lossless webp": _pil_bytes(img, "WEBP", lossless=True),
        "lzw tiff": _pil_bytes(img, "TIFF", compression="tiff_lzw"),
        "p3 ppm": b"P3\n2 1\n255\n1 2 3 4 5 6\n",
        "p4 pbm": _pil_bytes(img.convert("1"), "PPM"),
    }


@pytest.mark.parametrize("case", ["jpeg", "gif", "16-bit png", "interlaced png", "16-bit ppm",
                                  "8-bit bmp", "cmyk jpeg", "lossy webp", "lossless webp",
                                  "lzw tiff", "p3 ppm", "p4 pbm"])
def test_formerly_refused_input_decodes_like_pil(case):
    data = _formerly_refused()[case]
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


# -- PNG at 16 bits and Adam7 -------------------------------------------------------

def _pack(samples, depth):
    """(h, w, c) samples -> (h, row bytes) uint8 at `depth` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    pad = np.zeros((h, -(-n // per) * per), np.uint8)
    pad[:, :n] = flat
    groups = pad.reshape(h, -1, per).astype(np.uint8)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (groups << shifts).sum(-1).astype(np.uint8)


def _filter_rows(packed, bpp, first_filter=0):
    """Filter each row with filter (r + first_filter) % 5."""
    rows = packed.astype(np.int32)
    out = []
    for r in range(rows.shape[0]):
        x = rows[r]
        up = rows[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        f = (r + first_filter) % 5
        pred = [0, left, up, (left + up) // 2, paeth][f]
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _png(samples, ctype, depth, interlace=0, palette=None):
    """A PNG of `samples` (h, w, channels) at `depth` bits, Adam7 when
    `interlace`, each pass's rows cycling through the five filters."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for i, (y0, x0, dy, dx) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub, depth), bpp, first_filter=i)
    out = PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_SIG = b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_16_bit_is_pils(ctype):
    """16-bit grey clips at 255 (PIL's I;16); RGB, grey+alpha and RGBA keep
    the high byte."""
    rng = np.random.default_rng(10 + ctype)
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 65536, (13, 11, c)).astype(np.uint16)
    px[0, :4, 0] = [0x1234, 0x00FF, 0x0100, 0xFF80]
    px[1, :4, 0] = [0, 1, 254, 255]
    data = _png(px, ctype, 16)
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("ctype,depth,shape", [
    (2, 8, (13, 11)), (6, 8, (9, 17)), (0, 8, (1, 1)), (0, 1, (11, 13)), (0, 2, (5, 3)),
    (0, 4, (8, 9)), (3, 8, (10, 10)), (3, 2, (3, 9)), (2, 16, (7, 5)), (4, 16, (4, 4)),
    (0, 16, (2, 9))])
def test_png_adam7_is_pils(ctype, depth, shape):
    rng = np.random.default_rng(depth * 7 + ctype)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
    px = rng.integers(0, 1 << depth, shape + (c,)).astype(np.uint16 if depth == 16 else np.uint8)
    data = _png(px, ctype, depth, interlace=1, palette=palette)
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_png_index_past_the_palette_is_black():
    px = np.array([[[0], [1], [5], [200]]], np.uint8)
    data = _png(px, 3, 8, palette=np.array([[10, 20, 30], [40, 50, 60]], np.uint8))
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


# -- PNM at every maxval ------------------------------------------------------------

@pytest.mark.parametrize("magic", [b"P5", b"P6"])
@pytest.mark.parametrize("maxval", [1, 100, 254, 255, 256, 1000, 65534, 65535])
def test_pnm_every_maxval_is_pils(magic, maxval):
    bands = 3 if magic == b"P6" else 1
    rng = np.random.default_rng(maxval)
    px = rng.integers(0, maxval + 1, (6, 7, bands))
    px.flat[:4] = [0, maxval, maxval // 2, (maxval + 1) // 2]
    raster = px.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    data = magic + b"\n7 6\n%d\n" % maxval + raster
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_pnm_below_255_scales_as_pil_then_resizes_as_the_native_loader(tmp_path):
    """JAX's decode_resize_batch sends PPM batches through native/loader.cc,
    which copies a maxval-100 raster unscaled. The port's batch decoder
    scales the samples as PIL does and then resizes as loader.cc does: JAX's
    native resize of PIL's samples, within 1e-6 (JAX's library may contract
    its lerps into FMAs)."""
    from shmgan_tpu.data.loader import decode_resize_batch as j_decode_resize_batch
    from shmgan_tpu.runtime import native_loader as jnl
    from shmgan_tpu_torch.data.loader import decode_resize_batch

    assert jnl.build_native()
    px = np.random.default_rng(12).integers(0, 101, (20, 24, 3)).astype(np.uint8)
    path = str(tmp_path / "m100.ppm")
    with open(path, "wb") as f:
        f.write(b"P6\n24 20\n100\n" + px.tobytes())
    got = decode_resize_batch([path], 16, num_workers=1)
    with Image.open(path) as im:
        pil_samples = np.asarray(im.convert("RGB"))
    np.testing.assert_allclose(got[0], jnl.resize_normalize(pil_samples, 16), rtol=0, atol=1e-6)
    via_native, used_native = j_decode_resize_batch([path], 16, num_workers=1)
    assert used_native and np.abs(via_native - got).max() > 0.3   # 100 read as 100/255


# -- BMP variants -------------------------------------------------------------------

def _bmp(w, h, bits, pixels, palette=None, hsize=40, compression=0, masks=None,
         top_down=False, colors=0):
    """A BMP: file header, a `hsize`-byte info header (12: OS/2 core),
    BITFIELDS masks (inside a V4/V5 header, else after the 40-byte one),
    the palette, then `pixels` as given."""
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        extra = b""
        if masks is not None and hsize >= 56:
            extra = struct.pack("<IIII", *masks)
        elif masks is not None and hsize == 52:
            extra = struct.pack("<III", *masks[:3])
        info += (extra + bytes(hsize))[:hsize - 40]
        if masks is not None and hsize == 40:
            info += struct.pack("<III", *masks[:3])
    pal = palette or b""
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + pal + pixels


def _rows(h, w, bits, seed):
    """Random row data at `bits` a pixel, each row padded to 4 bytes."""
    stride = ((w * bits + 31) >> 3) & ~3
    return np.random.default_rng(seed).integers(0, 256, h * stride).astype(np.uint8).tobytes()


def _bgrx_palette(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n * 4).astype(np.uint8).tobytes()


def _rle8():
    """RLE8 rows of 7: runs, absolute runs (odd length, padded), a delta,
    end of line, end of bitmap."""
    return bytes([3, 5, 2, 9, 0, 3, 1, 2, 3, 0, 2, 7, 0, 0,
                  0, 2, 0, 0, 1, 1, 7, 4, 0, 0,
                  7, 200, 0, 0, 0, 5, 9, 8, 7, 6, 5, 0, 0, 0, 0, 1])


def _rle4():
    return bytes([5, 0x12, 0, 4, 0x34, 0x56, 2, 0xF0, 0, 0,
                  7, 0xAB, 0, 0, 0, 1])


_BMPS = {
    "1-bit": lambda: _bmp(13, 5, 1, _rows(5, 13, 1, 1), palette=_bgrx_palette(2, 1)),
    "4-bit": lambda: _bmp(13, 5, 4, _rows(5, 13, 4, 2), palette=_bgrx_palette(16, 2)),
    "4-bit short palette": lambda: _bmp(9, 4, 4, _rows(4, 9, 4, 3),
                                        palette=_bgrx_palette(5, 3), colors=5),
    "8-bit": lambda: _bmp(9, 6, 8, _rows(6, 9, 8, 4), palette=_bgrx_palette(256, 4)),
    "8-bit grey": lambda: _bmp(9, 6, 8, _rows(6, 9, 8, 5),
                               palette=b"".join(bytes([i, i, i, 0]) for i in range(256))),
    "16-bit 555": lambda: _bmp(7, 5, 16, _rows(5, 7, 16, 6)),
    "16-bit 565": lambda: _bmp(7, 5, 16, _rows(5, 7, 16, 7), compression=3,
                               masks=(0xF800, 0x7E0, 0x1F, 0)),
    "16-bit 555 bitfields v4": lambda: _bmp(7, 5, 16, _rows(5, 7, 16, 8), hsize=108,
                                            compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0)),
    "24-bit top-down": lambda: _bmp(7, 5, 24, _rows(5, 7, 24, 9), top_down=True),
    "32-bit": lambda: _bmp(6, 4, 32, _rows(4, 6, 32, 10)),
    "32-bit bitfields bgrx": lambda: _bmp(6, 4, 32, _rows(4, 6, 32, 11), compression=3,
                                          masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "32-bit bitfields xbgr v5": lambda: _bmp(6, 4, 32, _rows(4, 6, 32, 12), hsize=124,
                                             compression=3,
                                             masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    "32-bit bitfields rgba v4": lambda: _bmp(6, 4, 32, _rows(4, 6, 32, 13), hsize=108,
                                             compression=3,
                                             masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "rle8": lambda: _bmp(7, 4, 8, _rle8(), palette=_bgrx_palette(256, 14), compression=1),
    "rle8 top-down": lambda: _bmp(7, 4, 8, _rle8(), palette=_bgrx_palette(256, 15),
                                  compression=1, top_down=True),
    "rle4": lambda: _bmp(8, 2, 4, _rle4(), palette=_bgrx_palette(16, 16), compression=2),
    "os2 24-bit": lambda: _bmp(7, 5, 24, _rows(5, 7, 24, 17), hsize=12),
    "os2 8-bit": lambda: _bmp(9, 3, 8, _rows(3, 9, 8, 18), hsize=12,
                              palette=np.random.default_rng(18).integers(
                                  0, 256, 768).astype(np.uint8).tobytes()),
}


@pytest.mark.parametrize("case", list(_BMPS))
def test_bmp_variants_are_pils(case):
    data = _BMPS[case]()
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


# -- GIF ------------------------------------------------------------------------------

def _lzw_literal(indices, min_bits):
    """GIF LZW of `indices` as literal codes only, a clear code whenever the
    decoder's table would widen the codes."""
    clear = 1 << min_bits
    size, codes, table, prev = min_bits + 1, [clear], clear + 2, False
    for v in indices:
        if prev and table + 1 == (1 << size):
            codes.append(clear)
            table, prev = clear + 2, False
        codes.append(int(v))
        table += prev
        prev = True
    codes.append(clear + 1)
    acc = nacc = 0
    out = bytearray()
    for c in codes:
        acc |= c << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _gif(screen, frame, idx, global_pal=None, local_pal=None, transparency=None,
         interlace=False, min_bits=8):
    """A one-frame GIF: screen (w, h), frame (x0, y0, w, h), indices (h, w)."""
    def table(p):
        bits = max(1, int(np.ceil(np.log2(len(p)))))
        full = np.zeros((1 << bits, 3), np.uint8)
        full[:len(p)] = p
        return 0x80 | (bits - 1), full.tobytes()
    out = b"GIF89a" + struct.pack("<HH", *screen)
    flags, gt = table(global_pal) if global_pal is not None else (0, b"")
    out += bytes([flags, 0, 0]) + gt
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    out += b"\x21\xfe\x05hello\x00"                       # a comment extension
    flags, lt = table(local_pal) if local_pal is not None else (0, b"")
    rows = idx
    if interlace:
        flags |= 0x40
        order = np.concatenate([np.arange(s, idx.shape[0], st)
                                for s, st in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = idx[order]
    out += b"\x2c" + struct.pack("<HHHH", *frame) + bytes([flags]) + lt + bytes([min_bits])
    stream = _lzw_literal(rows.ravel(), min_bits)
    for i in range(0, len(stream), 255):
        out += bytes([len(stream[i:i + 255])]) + stream[i:i + 255]
    return out + b"\x00\x3b"


def _gifs():
    rng = np.random.default_rng(19)
    pal = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    idx = rng.integers(0, 200, (19, 23)).astype(np.uint8)
    img = Image.fromarray(_photo(37, 41, seed=20))
    return {
        "pil": lambda: _pil_bytes(img.quantize(100), "GIF", interlace=0),
        "pil interlaced": lambda: _pil_bytes(img.quantize(100), "GIF"),
        "pil grey": lambda: _pil_bytes(img.convert("L"), "GIF"),
        "pil transparency": lambda: _pil_bytes(img.quantize(60), "GIF", transparency=5),
        "global table": lambda: _gif((23, 19), (0, 0, 23, 19), idx, global_pal=pal),
        "local table": lambda: _gif((23, 19), (0, 0, 23, 19), idx, global_pal=pal[::-1],
                                    local_pal=pal),
        "interlaced": lambda: _gif((23, 19), (0, 0, 23, 19), idx, global_pal=pal,
                                   interlace=True),
        "small frame": lambda: _gif((30, 25), (3, 4, 23, 19), idx, global_pal=pal),
        "small frame transparent": lambda: _gif((30, 25), (3, 4, 23, 19), idx,
                                                global_pal=pal, transparency=7),
        "no table": lambda: _gif((23, 19), (0, 0, 23, 19), idx),
        "index past the table": lambda: _gif((23, 19), (0, 0, 23, 19), idx,
                                             global_pal=pal[:4]),
        "2-bit codes": lambda: _gif((23, 19), (0, 0, 23, 19), idx % 4, global_pal=pal[:4],
                                    min_bits=2),
    }


@pytest.mark.parametrize("case", list(_gifs()))
def test_gif_is_pils(case):
    data = _gifs()[case]()
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_list_images_equals_jax(tmp_path):
    for rel in ["b.png", "a.JPG", "notes.txt", "sub/c.bmp", "sub/deeper/d.png", "e.ppm"]:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    assert list_images(str(tmp_path)) == j_list_images(str(tmp_path))
    assert list_images(str(tmp_path / "missing")) == []


def _jpeg_with(patch):
    data = bytearray(_pil_bytes(Image.fromarray(_photo(16, 16, seed=9)), "JPEG"))
    sof = data.index(b"\xff\xc0")
    return bytes(patch(data, sof))


def _unsupported():
    img = Image.fromarray(_photo(16, 16, seed=9))
    png = _pil_bytes(img, "PNG")
    jpeg = _pil_bytes(img, "JPEG")
    gif = _pil_bytes(img, "GIF")
    bmp = _pil_bytes(img, "BMP")
    return {
        "truncated png": png[:len(png) // 2],
        "bad crc": png[:40] + bytes([png[40] ^ 1]) + png[41:],
        "truncated ppm": b"P6\n4 4\n255\n" + bytes(10),
        "truncated 16-bit pgm": b"P5\n4 4\n1000\n" + bytes(30),
        "maxval 0": b"P5\n1 1\n0\n" + bytes(1),
        "garbage": b"this is not an image",
        "empty": b"",
        "truncated jpeg": jpeg[:len(jpeg) // 2],
        "jpeg without eoi": jpeg[:-2],
        "lossless arithmetic jpeg": _jpeg_with(lambda d, i: d[:i + 1] + b"\xcb" + d[i + 2:]),
        "12-bit jpeg": _jpeg_with(lambda d, i: d[:i + 4] + b"\x0c" + d[i + 5:]),
        "lossless jpeg": _jpeg_with(lambda d, i: d[:i + 1] + b"\xc3" + d[i + 2:]),
        "hierarchical jpeg": _jpeg_with(lambda d, i: d[:i + 1] + b"\xc5" + d[i + 2:]),
        "truncated gif": gif[:len(gif) * 2 // 3],
        "truncated bmp": bmp[:len(bmp) - 20],
        "bmp bad bitfields": _bmp(2, 2, 32, bytes(16), compression=3,
                                  masks=(0xF00, 0xF0, 0xF, 0)),
        "bmp jpeg compression": _bmp(2, 2, 24, bytes(16), compression=4),
        "bmp 2-bit": _bmp(2, 2, 2, bytes(8), palette=bytes(16)),
    }


def test_huffman_data_under_an_arithmetic_frame_decodes_as_pil_decodes_it():
    """A baseline file whose SOF0 says SOF9: libjpeg-turbo arithmetic-decodes
    the Huffman data into other coefficients without an error, and so does
    the port, to the same pixels."""
    data = _jpeg_with(lambda d, i: d[:i + 1] + b"\xc9" + d[i + 2:])
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("case", list(_unsupported()))
def test_unsupported_input_raises(case):
    with pytest.raises(ValueError):
        codecs.decode(_unsupported()[case])


def _bombs():
    """Small files whose headers claim 65535 x 65535 pixels (a GIF: its frame
    at an offset, 131070 x 131070 in all), past the 2 * 89478485 PIL opens."""
    big = 65535
    gif_head = b"GIF89a" + struct.pack("<HHBBB", 1, 1, 0, 0, 0)
    gif_tail = b"\x02\x02\x4c\x01\x00\x3b"
    ihdr = codecs._png_chunk(b"IHDR", struct.pack(">IIBBBBB", big, big, 8, 2, 0, 0, 0))
    return {
        "jpeg": _jpeg_with(lambda d, i: d[:i + 5] + struct.pack(">HH", big, big) + d[i + 9:]),
        "gif screen": b"GIF89a" + struct.pack("<HHBBB", big, big, 0, 0, 0)
                      + b"\x2c" + struct.pack("<HHHHB", 0, 0, 1, 1, 0) + gif_tail,
        "gif frame": gif_head + b"\x2c" + struct.pack("<HHHHB", big, big, big, big, 0)
                     + gif_tail,
        "png": codecs.PNG_SIGNATURE + ihdr + codecs._png_chunk(b"IDAT", zlib.compress(b""))
               + codecs._png_chunk(b"IEND", b""),
        "pnm": f"P5\n{big} {big}\n255\n".encode() + bytes(1 << 16),
        "bmp": _bmp(big, big, 8, bytes(64), palette=bytes(1024)),
        # VP8L's sizes are 14-bit: 16383 x 16383 is the most a header claims
        "webp": _webp_vp8l_header(16383, 16383),
        "tiff": _tiff_header(big, big),
        "jpeg-in-tiff": _tiff_header(big, big, compression=7, photo=6),
        "ccitt group 4 tiff": _tiff_header(big, big, compression=4, photo=0, spp=1, bits=1),
        "arithmetic jpeg": _jpeg_with(lambda d, i: d[:i + 1] + b"\xc9"
                                      + d[i + 2:i + 5] + struct.pack(">HH", big, big) + d[i + 9:]),
    }


def _webp_vp8l_header(w, h):
    """A lossless WebP whose header claims w x h, over a 1x1 image's data."""
    one = _pil_bytes(Image.fromarray(np.zeros((1, 1, 3), np.uint8)), "WEBP", lossless=True)
    (n,) = struct.unpack_from("<I", one, 16)
    vp8l = b"\x2f" + ((w - 1) | ((h - 1) << 14)).to_bytes(4, "little") + one[25:20 + n]
    vp8l += b"\0" * (len(vp8l) & 1)
    return (b"RIFF" + struct.pack("<I", 12 + len(vp8l)) + b"WEBPVP8L"
            + struct.pack("<I", len(vp8l)) + vp8l)


def _tiff_header(w, h, compression=1, photo=2, spp=3, bits=8):
    """A TIFF header (RGB, uncompressed, unless asked) that claims w x h, and
    3 bytes of data."""
    tags = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, compression), (262, 3, photo),
            (273, 4, 8), (277, 3, spp), (278, 4, 1), (279, 4, 3)]
    ifd = struct.pack("<H", len(tags)) + b"".join(struct.pack("<HHII", t, k, 1, v)
                                                  for t, k, v in tags) + bytes(4)
    return b"II*\x00" + struct.pack("<I", 12) + bytes(4) + ifd


@pytest.mark.parametrize("case", list(_bombs()))
def test_decompression_bomb_header_is_refused_before_decoding(case):
    """PIL refuses these in Image.open; the port raises ValueError from the
    header, before it allocates for the claimed size."""
    data = _bombs()[case]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="PIL opens"):
        codecs.decode(data)


def test_png_inflates_no_further_than_its_scanlines():
    """An IDAT stream whose scanlines are followed by 64 MiB of zeros (it
    compresses to ~64 KiB) decodes as PIL decodes it, without inflating the
    rest."""
    img = _photo(6, 5, seed=3)
    raw = np.concatenate([np.zeros((6, 1), np.uint8), img.reshape(6, 15)], 1).tobytes()
    idat = zlib.compress(raw + bytes(64 << 20), 9)
    data = (codecs.PNG_SIGNATURE
            + codecs._png_chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 2, 0, 0, 0))
            + codecs._png_chunk(b"IDAT", idat) + codecs._png_chunk(b"IEND", b""))
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))
    np.testing.assert_array_equal(codecs.decode(data), img)


def _zstd_tiff(w, h, strip):
    """An RGB TIFF of one strip compressed with Zstd (50000)."""
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 50000), (262, 3, 2),
            (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 3), (278, 4, h), (279, 4, len(strip))]
    ifd = struct.pack("<H", len(tags)) + b"".join(struct.pack("<HHII", t, k, 1, v)
                                                  for t, k, v in tags) + bytes(4)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + strip


def _zstd_rle_block(n, byte, last=False, window=7 << 3):
    """A Zstd frame header (no content size, a window of 2 ** (10 + window
    >> 3) bytes) when `n` is None, else an RLE block of n bytes."""
    if n is None:
        return struct.pack("<I", 0xFD2FB528) + bytes([0, window])
    return ((n << 3) | 2 | last).to_bytes(3, "little") + bytes([byte])


def _zstd_bombs():
    """8 x 8 TIFFs (192 bytes of pixels) whose ~8 KB strips inflate to
    262 MB of RLE blocks, or 131 MB of compressed blocks: each one raw
    literal, then one sequence (RLE-coded tables: literal length 1, offset
    1, match length code 51 with all 15 extra bits set) that copies it
    65538 times."""
    frame = _zstd_rle_block(None, 0)
    seq = bytes([8, 65, 1, 0x54, 1, 2, 51]) + ((1 << 17) | 32767).to_bytes(3, "little")
    comp = lambda last=False: ((len(seq) << 3) | 4 | last).to_bytes(3, "little") + seq  # noqa
    return {"rle blocks": frame + b"".join(_zstd_rle_block(1 << 17, 9) for _ in range(2000))
                          + _zstd_rle_block(1, 9, True),
            "compressed blocks": frame + b"".join(comp() for _ in range(2000)) + comp(True)}


@pytest.mark.parametrize("case", list(_zstd_bombs()))
def test_zstd_tiff_inflates_no_further_than_its_strip(case):
    """libtiff's Zstd codec stops at the end of its strip buffer; so does the
    port's decoder, inside a frame and inside a block, and the pixels are
    PIL's."""
    data = _zstd_tiff(8, 8, _zstd_bombs()[case])
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))
    tracemalloc.start()                 # a second decode: the modules are imported
    try:
        codecs.decode(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak


@pytest.mark.parametrize("window,n", [(7 << 3, (1 << 21) - 1), (0, 2048)],
                         ids=["2 MB under 128 KiB", "2 KiB under a 1 KiB window"])
def test_zstd_block_past_its_maximum_is_refused(window, n):
    """RFC 8878's Block_Maximum_Size, min(Window_Size, 128 KiB): a larger
    block is corrupt, for libzstd (PIL raises OSError) and for the port."""
    data = _zstd_tiff(8, 8, _zstd_rle_block(None, 0, window=window)
                      + _zstd_rle_block(n, 5, True))
    with pytest.raises(OSError):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="Zstd data .*past its maximum"):
        codecs.decode(data)


def test_webp_canvas_past_the_limit_is_refused_from_its_header():
    """A VP8X canvas of 65535 x 65535 (its sizes are 24-bit): refused before
    the frame is read."""
    u24 = lambda v: v.to_bytes(3, "little")        # noqa: E731
    vp8x = bytes(4) + u24(65534) + u24(65534)
    data = b"RIFF" + struct.pack("<I", 4 + 18 + 8) + b"WEBPVP8X" + struct.pack("<I", 10) + vp8x
    data += b"VP8L" + bytes(4)
    with pytest.raises(ValueError, match="65535x65535 .* PIL opens"):
        codecs.decode(data)


# -- plain and bilevel PNM ----------------------------------------------------------

def _plain_pnms():
    rng = np.random.default_rng(21)
    out = {}
    for maxval in (1, 7, 100, 255, 256, 1000, 65535):
        v = rng.integers(0, maxval + 1, (5, 9, 3))
        out[f"p3 maxval {maxval}"] = (b"P3\n# a comment\n9 5\n%d\n" % maxval
                                      + b" ".join(b"%d" % x for x in v.ravel()) + b"\n")
        out[f"p2 maxval {maxval}"] = (b"P2 9 5 %d\r\n" % maxval
                                      + b"\n".join(b"%d" % x for x in v[..., 0].ravel()))
    v = rng.integers(0, 256, (4, 6, 3))
    lines = [b" ".join(b"%d" % x for x in row) for row in v.reshape(4, -1)]
    out["p3 comments between rows"] = b"P3 6 4 255\n" + b" # note\n".join(lines)
    out["p3 comment joins two tokens"] = b"P3\n2 1\n255\n1#x\n2 3 4 5 6 7\n"
    bits = rng.integers(0, 2, (5, 13))
    out["p1 packed"] = b"P1\n13 5\n" + b"".join(b"%d" % x for x in bits.ravel())
    out["p1 spaced, comment"] = (b"P1 13 5\n# c\n" + b" ".join(b"%d" % x for x in bits.ravel())
                                 + b"\n")
    img = Image.fromarray(_photo(7, 13, seed=22)).convert("1")
    out["p4 odd width"] = _pil_bytes(img, "PPM")
    out["p4 comment in header"] = b"P4\n# c\n8 2\n" + bytes([0b10110001, 0b01001110])
    return out


@pytest.mark.parametrize("case", list(_plain_pnms()))
def test_plain_and_bilevel_pnm_are_pils(case):
    data = _plain_pnms()[case]
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("data,match", [
    (b"P3\n2 1\n100\n1 2 3 4 5 101\n", "outside"),
    (b"P3\n2 1\n255\n1 2 3 4 5\n", "truncated"),
    (b"P1\n2 2\n1 0 2 1\n", "not 0 or 1"),
    (b"P1\n3 2\n1 0 1\n", "truncated"),
    (b"P4\n9 2\n\x00\x00\x00", "truncated"),
    (b"P3\n1 1\n255\n12345678901 0 0", "too long"),
], ids=["past maxval", "p3 cut short", "bad p1 digit", "p1 cut short", "p4 cut short",
        "long token"])
def test_bad_plain_pnm_raises(data, match):
    with pytest.raises(ValueError, match=match):
        codecs.decode(data)


# -- formats PIL opens that the port does not ---------------------------------------

def _unported():
    img = Image.fromarray(_photo(16, 16, seed=23))
    return {
        "AVIF": _pil_bytes(img, "AVIF"),
        "BLP": _pil_bytes(img.quantize(16), "BLP"),
    }


@pytest.mark.parametrize("name", list(_unported()))
def test_formats_pil_opens_and_the_port_does_not_are_refused_by_name(name):
    data = _unported()[name]
    assert _pil_rgb(data).shape[2] == 3
    with pytest.raises(ValueError, match=f"{name}.*PIL opens this format"):
        codecs.decode(data)


# -- the loader on the new formats --------------------------------------------------

def _photo_files():
    img = Image.fromarray(_photo(45, 61, seed=24))
    return {
        "lossy.webp": _pil_bytes(img, "WEBP", quality=80),
        "lossless.webp": _pil_bytes(img, "WEBP", lossless=True),
        "lzw.tif": _pil_bytes(img, "TIFF", compression="tiff_lzw"),
        "cmyk.jpg": _pil_bytes(img.convert("CMYK"), "JPEG", quality=85),
        "p3.ppm": b"P3\n61 45\n255\n" + b" ".join(b"%d" % v for v in _photo(45, 61, 24).ravel()),
        "p4.ppm": _pil_bytes(img.convert("1"), "PPM"),
    }


@pytest.mark.parametrize("name", list(_photo_files()))
@pytest.mark.parametrize("image_size", [16, 64])
def test_photo_formats_decode_resize_and_original_equal_jax(tmp_path, name, image_size):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(_photo_files()[name])
    np.testing.assert_array_equal(decode_resize(path, image_size),
                                  j_decode_resize(path, image_size))
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


def test_only_jaxs_extensions_are_listed_and_a_file_is_read_by_its_bytes(tmp_path):
    """A .webp or .tif file is not listed, as in JAX; a WebP named .png is,
    and decodes as JAX's PIL decodes it."""
    files = _photo_files()
    for name, data in (("a.webp", files["lossy.webp"]), ("b.tif", files["lzw.tif"]),
                       ("c.png", files["lossy.webp"]), ("d.jpg", files["lzw.tif"])):
        (tmp_path / name).write_bytes(data)
    listed = list_images(str(tmp_path))
    assert listed == j_list_images(str(tmp_path))
    assert [os.path.basename(p) for p in listed] == ["c.png", "d.jpg"]
    for p in listed:
        np.testing.assert_array_equal(decode_original(p), j_decode_original(p))


def test_polarimetric_dataset_on_an_ascii_ppm_tree_is_jaxs(tmp_path):
    """Five view folders of P3 files: both loaders' native decoders refuse
    them and each goes alone through the per-file path (PIL's, in JAX), to
    the same batches."""
    rng = np.random.default_rng(25)
    for d in ("I0", "I45", "I90", "I135", "ED"):
        os.makedirs(tmp_path / d)
        for i in range(4):
            v = rng.integers(0, 256, (20, 24, 3))
            (tmp_path / d / f"img_{i:05d}.ppm").write_bytes(
                b"P3\n24 20\n255\n" + b"\n".join(b"%d" % x for x in v.ravel()))
    cfg = DataConfig(data_dir=str(tmp_path), cache_in_memory=False)
    jcfg = JDataConfig(data_dir=str(tmp_path), cache_in_memory=False)
    mine = PolarimetricDataset(cfg, 16, 2, num_workers=2)
    theirs = JPolarimetricDataset(jcfg, 16, 2, num_workers=2)
    got, want = list(mine.iter_epoch(None)), list(theirs.iter_epoch(None))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
