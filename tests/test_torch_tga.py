"""The port's TGA decoder (data/tga.py) against PIL 12's: every stream is
made here, by PIL's writer or by hand, and decoded by both; the port's
pixels equal PIL's `convert("RGB")` exactly, and where PIL refuses a body
the port raises ValueError.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tga.py
"""

import struct

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs
from torch_format_streams import photo, pil_bytes, pil_open, pil_rgb, tga, tga_rle

_IMG = photo(20, 27, seed=3)


def _pil_image(mode):
    img = Image.fromarray(_IMG)
    return img.quantize(40) if mode == "P" else img.convert(mode)


# PIL writes no run-length 1-bit TGA
@pytest.mark.parametrize("mode,rle", [(m, r) for m in ("RGB", "RGBA", "L", "LA", "P", "1")
                                      for r in (False, True) if not (m == "1" and r)])
@pytest.mark.parametrize("orientation", [-1, 1])
def test_pil_written_tgas_decode_to_pils_pixels(mode, rle, orientation):
    data = pil_bytes(_pil_image(mode), "TGA", rle=rle, orientation=orientation)
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))
    cut = data[:-26]                     # the same file with its footer taken off
    np.testing.assert_array_equal(codecs.decode(cut), pil_rgb(cut))


def test_a_footerless_type_2_tga_is_decoded_not_refused_as_cur():
    """00 00 02 00 starts both a plain type-2 TGA and a CUR: PIL's CUR finds
    no cursors in it and passes it on, and PIL opens it as TGA."""
    data = pil_bytes(Image.fromarray(photo(20, 24, seed=4)), "TGA")[:-26]
    assert data[:4] == b"\x00\x00\x02\x00"
    assert pil_open(data)[0] == "TGA"
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


def _rows(px, depth):
    h = px.shape[0]
    return [px[y].tobytes() for y in range(h)]


def _hand_made():
    rng = np.random.default_rng(5)
    w, h = 19, 13
    p16 = rng.integers(0, 65536, (h, w), dtype=np.uint16).astype("<u2")
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[:, 4:12] = rgb[:, 4:5]                                  # runs
    idx = rng.integers(0, 6, (h, w), dtype=np.uint8)
    map24 = rng.integers(0, 256, 18, dtype=np.uint8).tobytes()
    map16 = rng.integers(0, 65536, 6, dtype=np.uint16).astype("<u2").tobytes()
    grey16 = rng.integers(0, 256, (h, w, 2), dtype=np.uint8)
    bits = np.packbits(rng.integers(0, 2, (h, w), dtype=np.uint8), axis=1)
    out = {
        "16-bit true colour": tga(w, h, 2, 16, p16.tobytes()),
        "16-bit run-length": tga(w, h, 10, 16, tga_rle(_rows(p16, 16), 2)),
        "24-bit, mirrored (0x10)": tga(w, h, 2, 24, rgb.tobytes(), flags=0x10),
        "24-bit, top-down mirrored (0x30)": tga(w, h, 2, 24, rgb.tobytes(), flags=0x30),
        "24-bit, an ID field": tga(w, h, 2, 24, rgb.tobytes(), ident=b"made by hand" * 3),
        "24-bit run-length, literals across rows": tga(w, h, 10, 24,
                                                       tga_rle(_rows(rgb, 24), 3, seed=1)),
        "32-bit, attribute bits": tga(w, h, 2, 32, np.concatenate(
            [rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1).tobytes(), flags=8),
        "colour map, first index 3": tga(w, h, 1, 8, (idx + 3).tobytes(), map24, first=3,
                                         cmap_depth=24),
        "16-bit colour map": tga(w, h, 1, 8, idx.tobytes(), map16, cmap_depth=16),
        "indices past the map": tga(w, h, 1, 8, (idx * 40).tobytes(), map24, cmap_depth=24),
        "colour-mapped run-length": tga(w, h, 9, 8, tga_rle(_rows(idx, 8), 1), map24,
                                        cmap_depth=24, flags=0x20),
        "grey with alpha, run-length": tga(w, h, 11, 16, tga_rle(_rows(grey16, 16), 2)),
        "1-bit grey": tga(w, h, 3, 1, bits.tobytes(), flags=0x20),
        "256 map entries": tga(w, h, 1, 8, idx.tobytes(), bytes(3 * 250) + map24, first=0,
                               cmap_depth=24),
    }
    return out


@pytest.mark.parametrize("name", list(_hand_made()))
def test_hand_made_tgas_decode_to_pils_pixels(name):
    data = _hand_made()[name]
    fmt, want = pil_open(data)
    assert fmt == "TGA" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _refused():
    rgb = bytes(range(6))
    return {
        # a run packet that crosses a row's end: PIL's buffer overrun
        "run across a row": tga(3, 2, 11, 8, bytes([0x83, 7, 0x81, 9])),
        "colour-mapped with no map": tga(2, 2, 1, 8, bytes(4)),
        "colour map beside RGB": tga(2, 1, 2, 24, rgb, bytes(6), cmap_depth=24),
        "32-bit colour map": tga(2, 1, 1, 8, bytes(2), bytes(8), cmap_depth=32),
        "257 map entries": tga(2, 1, 1, 8, bytes(2), bytes(21), first=250, cmap_depth=24),
        "run-length 1-bit": tga(9, 1, 11, 1, bytes([0x01, 0xFF, 0x80])),
        "8-bit true colour": tga(2, 1, 2, 8, bytes(2)),
        "truncated raw": tga(4, 4, 3, 8, bytes(10)),
        "truncated run-length": tga(4, 4, 11, 8, bytes([0x83, 1, 0x03, 1, 2])),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_pil_cannot_load_is_refused(name):
    data = _refused()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match="TGA"):
        codecs.decode(data)


@pytest.mark.parametrize("header", [
    tga(2, 2, 2, 15, bytes(8)),                        # depth 15: not PIL's TGA
    tga(2, 2, 4, 8, bytes(4)),                         # image type 4
    tga(0, 2, 2, 24, bytes(6)),                        # empty
    tga(2, 2, 2, 24, bytes(12), cmap_type=2),          # colour-map type 2
    tga(2, 2, 1, 8, bytes(4), bytes(6), cmap_depth=8),  # colour-map depth 8
], ids=["depth 15", "type 4", "empty", "map type 2", "map depth 8"])
def test_headers_pil_does_not_take_for_tga_are_unrecognised(header):
    assert pil_open(header)[0] is None
    with pytest.raises(ValueError, match="unrecognised"):
        codecs.decode(header)


def test_every_cut_of_a_run_length_tga_is_refused_with_value_error():
    data = pil_bytes(Image.fromarray(photo(16, 20, seed=6)), "TGA", rle=True)[:-26]
    for cut in range(18, len(data), 37):
        with pytest.raises(ValueError):
            codecs.decode(data[:cut])


def test_a_footer_is_read_by_the_header_not_the_footer():
    data = pil_bytes(Image.fromarray(photo(16, 20, seed=7)), "TGA") + b"trailing bytes"
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))
    assert struct.unpack("<HH", data[12:16]) == (20, 16)
