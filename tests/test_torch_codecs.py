"""The port's image codecs (data/codecs.py) and loader (data/loader.py)
against PIL and the JAX package's loader, on the CPU: decoded pixels equal
PIL's `convert("RGB")` for every PNG colour type with every row filter, for
PPM, PGM and BMP; `decode_resize` equals JAX's (Pillow's BILINEAR) exactly
at up- and downscales; PNGs the port writes read back under PIL; what the
port does not decode raises ValueError."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.data.loader import decode_original as j_decode_original
from shmgan_tpu.data.loader import decode_resize as j_decode_resize
from shmgan_tpu.data.loader import list_images as j_list_images
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data.loader import decode_original, decode_resize, list_images


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


@pytest.mark.parametrize("shape", [(17, 23, 3), (17, 23), (17, 23, 1), (1, 1, 3)])
def test_encode_png_reads_back_under_pil(shape):
    img = np.random.default_rng(8).integers(0, 256, shape, np.uint8)
    data = codecs.encode_png(img)
    with Image.open(io.BytesIO(data)) as im:
        got = np.asarray(im)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    np.testing.assert_array_equal(codecs.decode(data)[..., 0], img.reshape(shape[:2] + (-1,))[..., 0])


def _unsupported():
    img = Image.fromarray(_photo(16, 16, seed=9))
    png = _pil_bytes(img, "PNG")
    return {
        "jpeg": _pil_bytes(img, "JPEG"),
        "gif": _pil_bytes(img, "GIF"),
        "16-bit png": _pil_bytes(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                                                 * 1000), "PNG"),
        "interlaced png": _filtered_png(np.zeros((4, 4, 3), np.uint8), 2, interlace=1),
        "truncated png": png[:len(png) // 2],
        "bad crc": png[:40] + bytes([png[40] ^ 1]) + png[41:],
        "16-bit ppm": b"P6\n2 2\n65535\n" + bytes(24),
        "truncated ppm": b"P6\n4 4\n255\n" + bytes(10),
        "8-bit bmp": _pil_bytes(img.convert("L"), "BMP"),
        "garbage": b"this is not an image",
        "empty": b"",
    }


@pytest.mark.parametrize("case", list(_unsupported()))
def test_unsupported_input_raises(case):
    with pytest.raises(ValueError):
        codecs.decode(_unsupported()[case])


def test_list_images_equals_jax(tmp_path):
    for rel in ["b.png", "a.JPG", "notes.txt", "sub/c.bmp", "sub/deeper/d.png", "e.ppm"]:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    assert list_images(str(tmp_path)) == j_list_images(str(tmp_path))
    assert list_images(str(tmp_path / "missing")) == []
