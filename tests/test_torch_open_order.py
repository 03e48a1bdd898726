"""`codecs.decode` tells a file as `Image.open` tells it, and the new formats
reach the serving, folder and dataset routes as JAX's PIL path reads them.

  - the open order: crafted prefixes and whole streams give PIL's format
    (or its refusal) and the port's matching decode, or a refusal naming
    the format PIL named;
  - each new format through `serve_http._decode_request_image` (at 256 and
    native) and `data/loader.decode_original` and `decode_resize` (a file
    named .png), against the JAX package's on the same bytes;
  - bombs: a header of more pixels than PIL opens is refused before any
    large allocation.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_open_order.py
"""

import functools
import struct
import tracemalloc

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.data.loader import decode_original as j_decode_original
from shmgan_tpu.data.loader import decode_resize as j_decode_resize
from shmgan_tpu.serve_http import _decode_request_image as j_decode_request_image
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data.loader import decode_original, decode_resize
from shmgan_tpu_torch.serve_http import _decode_request_image
from torch_format_streams import (dds, dib, icns, icon_dir, photo, pil_bytes, pil_open, psd,
                                  sgi, tga)

_PHOTO = photo(29, 43, seed=61)


def _pcx_dcx(page):
    return struct.pack("<III", 0x3ADE68B1, 12, 0) + page


@functools.lru_cache(maxsize=1)
def _bodies():
    """One body of each new format, 29 x 43 (or the format's own size)."""
    img = Image.fromarray(_PHOTO)
    rng = np.random.default_rng(62)
    idx = rng.integers(0, 256, (29, 43), dtype=np.uint8)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    is32 = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8).tobytes()
    pcx = pil_bytes(img, "PCX")
    return {
        "TGA": pil_bytes(img, "TGA"),
        "TGA, no footer": pil_bytes(img, "TGA", rle=True)[:-26],
        "PSD": psd(np.moveaxis(_PHOTO, -1, 0), 3, compression=1),
        "ICO, PNG entry": pil_bytes(img, "ICO", sizes=[(43, 29)]),
        "ICO, BMP entry": pil_bytes(img, "ICO", sizes=[(43, 29)], bitmap_format="bmp"),
        "CUR": icon_dir(2, [(43, 29, 8, dib(idx, 8, palette))]),
        "ICNS": icns([(b"is32", is32), (b"s8mk", bytes(256))]),
        "QOI": pil_bytes(img, "QOI"),
        "PCX": pcx,
        "DCX": _pcx_dcx(pcx),
        "SGI": pil_bytes(img, "SGI"),
        "PFM": pil_bytes(Image.fromarray(_PHOTO[..., 1].astype(np.float32) * 1.1), "PPM"),
        "MSP": pil_bytes(img.convert("1"), "MSP"),
        "XBM": pil_bytes(img.convert("1"), "XBM"),
        "DDS": pil_bytes(img.convert("RGBA"), "DDS", pixel_format="DXT5"),
        "DIB": pil_bytes(img, "DIB"),
    }


# -- the open order ------------------------------------------------------------------

def _open_order():
    good_tga = pil_bytes(Image.fromarray(photo(16, 24, seed=63)), "TGA")[:-26]
    pcx = pil_bytes(Image.fromarray(photo(16, 24, seed=64)), "PCX")
    # version 0, x0 past x1 (not PIL's PCX), byte 16 (a TGA's depth) 8: PIL's TGA opens it
    bad_pcx = pcx[:1] + b"\x00" + pcx[2:4] + struct.pack("<H", 100) + pcx[6:16] + b"\x08" + pcx[17:]
    rng = np.random.default_rng(65)
    cmap_tga = tga(24, 16, 1, 8, rng.integers(0, 4, 384, dtype=np.uint8).tobytes(),
                   bytes(range(12)), cmap_depth=24)
    return {
        # (bytes, PIL's format, the word the port's refusal names where PIL cannot decode)
        "a footerless type-2 TGA (CUR's signature)": (good_tga, "TGA", None),
        "a CUR": (_bodies()["CUR"], "CUR", None),
        "a CUR of no cursors, too short for a TGA": (b"\x00\x00\x02\x00\x00\x00" + bytes(8),
                                                     None, "unrecognised"),
        "a TGA whose first bytes are ICO's": (tga(24, 16, 1, 8, bytes(384)), "TGA", "TGA"),
        "a colour-mapped TGA (00 01 01 00)": (cmap_tga, "TGA", None),
        "a PCX": (pcx, "PCX", None),
        "a DCX": (_pcx_dcx(pcx), "DCX", None),
        "a PCX PIL passes on to TGA": (bad_pcx, "TGA", "TGA"),
        "an ICO": (_bodies()["ICO, BMP entry"], "ICO", None),
        "a DIB": (_bodies()["DIB"], "DIB", None),
        "a PFM": (_bodies()["PFM"], "PPM", None),
        "a colour PF": (b"PF\n1 1\n-1.0\n" + bytes(12), None, "unrecognised"),
        "an XBM after white space": (b"  " + _bodies()["XBM"], "XBM", None),
        "a PAM (P7)": (b"P7\nWIDTH 1\n", None, "unrecognised"),
        "a 16-bit PSD": (psd(np.zeros((3, 2, 8), np.uint8), 3, bits=16), None, "PSD"),
        "a PSB (version 2)": (b"8BPS\x00\x02" + bytes(40), None, "unrecognised"),
        "a QOI of width 0": (b"qoif" + bytes(8) + b"\x03\x00" + bytes(8), None, "unrecognised"),
        "an SGI of two channels": (sgi(np.zeros((2, 3, 3), np.uint8)), None, "SGI"),
        "a DDS of width 0": (dds(0, 4, 0x20000, bits=8, body=bytes(16)), None, "unrecognised"),
        "a BLP": (pil_bytes(Image.fromarray(photo(16, 16, seed=66)).quantize(16), "BLP"),
                  "BLP", "BLP"),
        "an AVIF": (pil_bytes(Image.fromarray(photo(16, 16, seed=67)), "AVIF"), "AVIF", "AVIF"),
        "an XV thumbnail (P7 332)": (b"P7 332\n#END_OF_COMMENTS\n2 1 255\n" + bytes(2),
                                     "XVThumb", "XVTHUMB"),
        "bytes of no format": (b"\x07" * 64, None, "unrecognised"),
    }


@pytest.mark.parametrize("name", list(_open_order()))
def test_the_open_order_agrees_with_image_open(name):
    data, fmt, word = _open_order()[name]
    got_fmt, want = pil_open(data)
    assert got_fmt == fmt
    if word is None:
        assert want is not None
        np.testing.assert_array_equal(codecs.decode(data), want)
    else:
        assert want is None or word in ("BLP", "AVIF", "XVTHUMB")   # PIL decodes these
        with pytest.raises(ValueError, match=word):
            codecs.decode(data)


# -- the entry points against JAX's ----------------------------------------------------

@pytest.mark.parametrize("name", list(_bodies()))
@pytest.mark.parametrize("size", [256, "native"])
def test_request_decode_equals_jaxs(name, size):
    body = _bodies()[name]
    np.testing.assert_array_equal(_decode_request_image(body, size),
                                  j_decode_request_image(body, size))


@pytest.mark.parametrize("name", list(_bodies()))
def test_decode_resize_and_original_equal_jax(tmp_path, name):
    path = str(tmp_path / "img.png")     # a file is decoded by its bytes, never its name
    with open(path, "wb") as f:
        f.write(_bodies()[name])
    got, want = decode_resize(path, 48), j_decode_resize(path, 48)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


# -- bombs ---------------------------------------------------------------------------

def _msp_header(w, h):
    words = [0x6144, 0x4D6E, w, h] + [0] * 12                   # DanM
    words[15] = functools.reduce(lambda a, b: a ^ b, words)     # the words XOR to 0
    return struct.pack("<16H", *words)


def _bombs():
    big = 65535
    return {
        "TGA": tga(big, big, 2, 24, bytes(64)),
        "PSD": b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 40000, 40000, 8, 3) + bytes(20),
        "ICO": icon_dir(1, [(0, 0, 24, struct.pack("<IiiHHIIiiII", 40, 40000, 80000, 1, 24,
                                                   0, 0, 0, 0, 0, 0) + bytes(64))]),
        "CUR": icon_dir(2, [(0, 0, 24, struct.pack("<IiiHHIIiiII", 40, 40000, 80000, 1, 24,
                                                   0, 0, 0, 0, 0, 0) + bytes(64))]),
        "QOI": b"qoif" + struct.pack(">IIBB", 40000, 40000, 3, 0) + b"\xfe\x01\x02\x03" * 8,
        "PCX": (bytes([10, 5, 1, 8]) + struct.pack("<HHHHHH", 0, 0, big - 1, big - 1, 72, 72)
                + bytes(48) + bytes([0, 3]) + struct.pack("<HH", big, 1) + bytes(58) + bytes(64)),
        "SGI": struct.pack(">HBBHHHH", 474, 0, 1, 3, big, big, 3) + bytes(600),
        "PFM": b"Pf\n40000 40000\n-1.0\n" + bytes(64),
        "MSP": _msp_header(big, big) + bytes(64),
        "XBM": b"#define a_width 40000\n#define a_height 40000\nstatic char a_bits[] = {0x01};",
        "DDS": dds(40000, 40000, 0x4, b"DXT1", body=bytes(64)),
        "DIB": struct.pack("<IiiHHIIiiII", 40, 40000, 40000, 1, 24, 0, 0, 0, 0, 0, 0) + bytes(64),
    }


@pytest.mark.parametrize("name", list(_bombs()))
def test_bombs_are_refused_before_a_large_allocation(name):
    data = _bombs()[name]
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="pixels"):
            codecs.decode(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 8 << 20, peak
