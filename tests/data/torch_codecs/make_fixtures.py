"""Writes the codec fixtures of this directory with PIL, and beside each
one `<name>.png`: PIL's `Image.open(fixture).convert("RGB")` pixels.

    PYTHONPATH=. python tests/data/torch_codecs/make_fixtures.py

The images are camera images of `synth_polar_scene` (seeded), so the
fixtures are the same on every run of the same PIL, libjpeg-turbo, libwebp
and libtiff. The formats PIL does not write (16-bit RGB and Adam7 PNG,
16-bit and maxval-100 P6, RLE8 BMP, a planar TIFF with the horizontal
predictor, YCCK JPEG, ASCII P3) are written by the small writers below;
JPEG-in-TIFF YCbCr, subsampled YCbCr LZW, arithmetic-coded and lossless
JPEG by the writers of tests/test_torch_tiff.py and tests/test_torch_jpeg.py;
a palette JP2 (PIL writes none) by rewriting the header boxes of its JP2;
STYLES_JP2 by tests/_opj_encode.py.
"""

import hashlib
import io
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

from shmgan_tpu_torch.data.synthetic import camera_image, synth_polar_scene

HERE = os.path.dirname(os.path.abspath(__file__))
# the 612x816 JPEG 2000 photo, beside it <name>.sha256 of PIL's pixels
PHOTO_JP2 = "photo_612x816.jp2"
# 4:2:0 sYCC, styles 0x3f, SOP, EPH; beside it <name>.sha256
STYLES_JP2 = "jp2_sycc420_styles.jp2"


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


def planar_tiff(rgb):
    """A little-endian TIFF of (h, w, 3) uint8: planar configuration 2 (one
    plane a sample), each plane in strips of 16 rows, horizontal predictor
    (2), Deflate (8)."""
    h, w, _ = rgb.shape
    strips = []
    for c in range(3):
        for y in range(0, h, 16):
            rows = rgb[y:y + 16, :, c].astype(np.int16)
            diff = np.concatenate([rows[:, :1], np.diff(rows, axis=1)], 1) % 256
            strips.append(zlib.compress(diff.astype(np.uint8).tobytes(), 9))
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    n = len(strips)
    arrays = struct.pack(f"<{n}I", *offsets) + struct.pack(f"<{n}I", *map(len, strips))
    ifd_at = pos + len(arrays) + 6
    tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, pos + len(arrays)), (259, 3, 1, 8),
            (262, 3, 1, 2), (273, 4, n, pos), (277, 3, 1, 3), (278, 3, 1, 16),
            (279, 4, n, pos + 4 * n), (284, 3, 1, 2), (317, 3, 1, 2)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, k, c) + (struct.pack("<HH", v, 0) if k == 3 and c == 1
                                        else struct.pack("<I", v)) for t, k, c, v in tags)
    return (b"II*\x00" + struct.pack("<I", ifd_at) + b"".join(strips) + arrays
            + struct.pack("<HHH", 8, 8, 8) + ifd + b"\x00" * 4)


def ycck(cmyk_jpeg):
    """PIL's CMYK JPEG with its Adobe segment's transform set to 2: the same
    coefficients read as YCCK."""
    i = cmyk_jpeg.index(b"Adobe")
    return cmyk_jpeg[:i + 11] + b"\x02" + cmyk_jpeg[i + 12:]


def variants(tiny):
    """The TIFF and JPEG variants beyond baseline, one of each family, from
    the writers of tests/test_torch_tiff.py and tests/test_torch_jpeg.py
    (which PIL's encoders cannot write) or PIL's encoder, at 24x16."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import test_torch_jpeg as tj
    import test_torch_tiff as tt

    im = Image.fromarray(tiny)
    ycc = tt._ycbcr_samples(tiny)
    bilevel = Image.fromarray(tiny[..., 1] > 100)
    return {
        "tiff_jpeg_ycbcr.tif": tt._jpeg_in_tiff(tiny, (2, 2), "strips", True),
        "tiff_ycbcr_lzw.tif": tt._tiff(
            ycc, 8, 6, compression=5, rows_per_strip=8,
            chunks=[tt._lzw_encode(c) for c in tt._ycbcr_blocks(ycc, (2, 2), 8)],
            extra_tags=((530, (3, [2, 2])),)),
        "tiff_float.tif": pil(Image.fromarray(tiny[..., 1].astype(np.float32) * 1.3 - 20.25),
                              "TIFF", compression="tiff_adobe_deflate"),
        "tiff_lzma.tif": pil(im, "TIFF", compression="lzma"),
        "tiff_zstd.tif": pil(im, "TIFF", compression="zstd"),
        "tiff_cielab.tif": pil(im.convert("LAB"), "TIFF", compression="tiff_lzw"),
        "tiff_group4.tif": pil(bilevel, "TIFF", compression="group4"),
        "arithmetic.jpg": tj.arith_version(pil(im, "JPEG", quality=85)),
        "lossless.jpg": tj._lossless_jpeg(tiny, 4),
    }


def jp2_palette(indices, palette):
    """A palette JP2: PIL's JP2 of the 8-bit indices, its header rewritten to
    an sRGB colr, a pclr of the palette's 8-bit entries and a cmap."""
    data = pil(Image.fromarray(indices), "JPEG2000")
    box = lambda kind, body: struct.pack(">I", 8 + len(body)) + kind + body
    ihdr = data[data.index(b"ihdr") + 4:data.index(b"ihdr") + 18]
    pclr = struct.pack(">HB", len(palette), 3) + bytes([7, 7, 7]) + palette.tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3))
    header = box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
                 + box(b"pclr", pclr) + box(b"cmap", cmap))
    start = data.index(b"jp2h") - 4
    end = start + struct.unpack(">I", data[start:start + 4])[0]
    return data[:start] + header + data[end:]


def jpeg2000():
    """Small JPEG 2000 fixtures (24x16) and the 612x816 photo, whose pixels
    are pinned by the SHA-256 of PIL's convert("RGB") bytes (a PNG of them
    would not fit the directory's byte budget)."""
    small = u8(scene(16, 24, 12))
    im = Image.fromarray(small)
    rgba = Image.fromarray(np.dstack([small, u8(scene(16, 24, 13))[..., 0]]), "RGBA")
    grey16 = Image.fromarray((scene(16, 24, 14)[..., 0] * 300).astype(np.uint16)).convert("I;16")
    pal = im.quantize(16)
    palette = np.array(pal.getpalette()[:48], np.uint8).reshape(16, 3)
    out = {
        "jp2_lossless.jp2": pil(im, "JPEG2000"),
        "j2k_97_layers.j2k": pil(im, "JPEG2000", no_jp2=True, irreversible=True,
                                 quality_layers=[20, 8, 3], mct=1),
        "jp2_tiled_cprl.jp2": pil(im, "JPEG2000", tile_size=(8, 8), progression="CPRL",
                                  precinct_size=(16, 16), num_resolutions=3),
        "j2k_grey16.j2k": pil(grey16, "JPEG2000", no_jp2=True),
        "jp2_rgba.jp2": pil(rgba, "JPEG2000"),
        "jp2_palette.jp2": jp2_palette(np.asarray(pal), palette),
    }
    photo = pil(Image.fromarray(u8(scene(612, 816, 15))), "JPEG2000", irreversible=True,
                quality_layers=[1000, 500, 200])
    return out, photo


def jp2_styles():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from _opj_encode import ycc420_styles
    return ycc420_styles(u8(scene(16, 16, 16)))


def write_with_sha256(name, data):
    """`data` as `name`, beside it the SHA-256 of PIL's pixels."""
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(data)
    with Image.open(io.BytesIO(data)) as im:
        digest = hashlib.sha256(np.ascontiguousarray(im.convert("RGB")).tobytes()).hexdigest()
    with open(os.path.join(HERE, name + ".sha256"), "w") as f:
        f.write(digest + "\n")


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
    small = u8(scene(48, 64, 7))
    sm = Image.fromarray(small)
    alpha = Image.fromarray(u8(scene(48, 64, 8))[..., 0])
    rgba = sm.copy()
    rgba.putalpha(alpha)
    out["webp_lossy.webp"] = pil(sm, "WEBP", quality=80, method=4)
    out["webp_lossless.webp"] = pil(sm, "WEBP", lossless=True, method=6, exact=True)
    out["webp_rgba.webp"] = pil(rgba, "WEBP", quality=80)
    out["webp_animated.webp"] = pil(sm, "WEBP", quality=80, save_all=True, duration=100,
                                    append_images=[Image.fromarray(small[::-1])])
    out["tiff_lzw_rgb.tif"] = pil(sm, "TIFF", compression="tiff_lzw")
    out["tiff_deflate_grey16.tif"] = pil(
        Image.fromarray((scene(48, 64, 9)[..., 0] * 400).astype(np.uint16)), "TIFF",
        compression="tiff_adobe_deflate")                   # values past 255: PIL clips
    out["tiff_packbits_palette.tif"] = pil(sm.quantize(64), "TIFF", compression="packbits")
    out["tiff_planar.tif"] = planar_tiff(small)
    cmyk = pil(sm.convert("CMYK"), "JPEG", quality=85)
    out["cmyk.jpg"] = cmyk
    out["ycck.jpg"] = ycck(cmyk)
    out.update(variants(u8(scene(16, 24, 11))))
    p3 = u8(scene(24, 32, 10))
    out["p3.ppm"] = (b"P3\n# ASCII PPM\n32 24\n255\n"
                     + "\n".join(" ".join(map(str, row)) for row in p3.reshape(24, -1)).encode()
                     + b"\n")
    return out


def main():
    small, photo = jpeg2000()
    write_with_sha256(PHOTO_JP2, photo)
    write_with_sha256(STYLES_JP2, jp2_styles())
    for name, data in sorted({**fixtures(), **small}.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            Image.fromarray(np.asarray(im.convert("RGB"))).save(
                os.path.join(HERE, name + ".png"), optimize=True)


if __name__ == "__main__":
    main()
