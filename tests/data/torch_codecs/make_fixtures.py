"""Writes the codec fixtures of this directory with PIL, and beside each
one `<name>.png`: PIL's `Image.open(fixture).convert("RGB")` pixels.

    PYTHONPATH=. python tests/data/torch_codecs/make_fixtures.py

The images are camera images of `synth_polar_scene` (seeded), so the
fixtures are the same on every run of the same PIL and libjpeg-turbo. The
formats PIL does not write (16-bit RGB and Adam7 PNG, 16-bit and maxval-100
P6, RLE8 BMP) are written by the small writers below.
"""

import io
import os
import struct
import zlib

import numpy as np
from PIL import Image

from shmgan_tpu_torch.data.synthetic import camera_image, synth_polar_scene

HERE = os.path.dirname(os.path.abspath(__file__))


def scene(h, w, seed):
    views, diffuse, _ = synth_polar_scene(np.random.default_rng(seed), h, w)
    return camera_image(diffuse, views)


def u8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def pil(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png(samples, ctype, depth, interlace=False):
    """A PNG of (h, w, c) samples, rows of filter 0, Adam7 when asked."""
    h, w, c = samples.shape
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
              (0, 1, 2, 2), (1, 0, 2, 1)) if interlace else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        for row in sub.reshape(sub.shape[0], -1):
            raw += b"\x00" + row.astype(">u2" if depth == 16 else np.uint8).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def rle8_bmp(idx, palette):
    """An RLE8 BMP: runs of equal indices, an end of line after each row
    (bottom row first), an end of bitmap."""
    h, w = idx.shape
    body = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            body += bytes([n, row[x]])
            x += n
        body += b"\x00\x00"
    body += b"\x00\x01"
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(body), 2835, 2835, 256, 0)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + bytes(body)


def fixtures():
    cam = u8(scene(256, 256, 1))
    im = Image.fromarray(cam)
    ex = Image.Exif()
    ex[0x0112] = 6                                   # orientation: rotate 90 CW
    q16 = [[max(1, int(v)) for v in np.linspace(300, 900, 64)],
           [max(1, int(v)) for v in np.linspace(400, 1200, 64)]]
    out = {
        "baseline_q50.jpg": pil(im, "JPEG", quality=50),
        "baseline_q75.jpg": pil(im, "JPEG", quality=75),
        "baseline_q95.jpg": pil(im, "JPEG", quality=95),
        "baseline_q100.jpg": pil(im, "JPEG", quality=100),
        "sub444.jpg": pil(im, "JPEG", quality=85, subsampling=0),
        "sub422.jpg": pil(im, "JPEG", quality=85, subsampling=1),
        "sub420.jpg": pil(im, "JPEG", quality=85, subsampling=2),
        "optimized.jpg": pil(im, "JPEG", quality=80, optimize=True),
        "restart.jpg": pil(im, "JPEG", quality=80, restart_marker_blocks=5),
        "grey.jpg": pil(im.convert("L"), "JPEG", quality=80),
        "progressive.jpg": pil(im, "JPEG", quality=80, progressive=True),
        "qtable16.jpg": pil(im, "JPEG", qtables=q16),
        "exif_orientation.jpg": pil(im, "JPEG", quality=80, exif=ex.tobytes()),
        "odd_1x1.jpg": pil(Image.fromarray(cam[:1, :1]), "JPEG", quality=80),
        "odd_17x23.jpg": pil(Image.fromarray(u8(scene(17, 23, 2))), "JPEG", quality=80),
        "photo_612x816.jpg": pil(Image.fromarray(u8(scene(612, 816, 3))), "JPEG", quality=90),
        "photo_2048x1536.jpg": pil(Image.fromarray(u8(scene(1536, 2048, 4))), "JPEG",
                                   quality=90),
        "palette.gif": pil(im.quantize(128), "GIF", interlace=0),
        "interlaced.gif": pil(im.quantize(128), "GIF", interlace=1),
    }
    rgb16 = (scene(96, 128, 5) * 65535).astype(np.uint16)
    out["rgb16.png"] = png(rgb16, 2, 16)
    out["grey16.png"] = png(rgb16[..., :1] // 64, 0, 16)       # values past 255: PIL clips
    out["adam7.png"] = png(cam[:99, :77], 2, 8, interlace=True)
    out["p6_16bit.ppm"] = b"P6\n128 96\n65535\n" + rgb16.astype(">u2").tobytes()
    out["p6_maxval100.ppm"] = (b"P6\n128 96\n100\n"
                               + (scene(96, 128, 6) * 100).round().astype(np.uint8).tobytes())
    pal = im.quantize(200)
    out["palette.bmp"] = pil(pal, "BMP")
    palette = np.array(pal.getpalette()[:600], np.uint8).reshape(-1, 3)
    palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
    out["rle8.bmp"] = rle8_bmp(np.asarray(pal), palette)
    return out


def main():
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            Image.fromarray(np.asarray(im.convert("RGB"))).save(
                os.path.join(HERE, name + ".png"), optimize=True)


if __name__ == "__main__":
    main()
