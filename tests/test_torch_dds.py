"""The port's DDS decoder (data/dds.py) against PIL 12's: DDS files PIL
writes (RGB, RGBA, L, LA, DXT1/3/5, BC2, BC3, BC5), seeded random blocks of
every block format PIL reads, under each FourCC and DX10 code, and of each
BC6H and BC7 mode, bit for bit, and headers built here for the
uncompressed layouts (channel masks, luminance, palettes, R8G8B8A8);
where PIL refuses a body the port raises ValueError.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dds.py
"""

import struct

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs
from torch_format_streams import dds, photo, pil_bytes, pil_open, pil_rgb

_IMG = Image.fromarray(photo(22, 37, seed=51))


@pytest.mark.parametrize("mode,fmt", [("RGB", None), ("RGBA", None), ("L", None), ("LA", None),
                                      ("RGBA", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"),
                                      ("RGBA", "BC2"), ("RGBA", "BC3"), ("RGB", "BC5")])
def test_pil_written_ddss_decode_to_pils_pixels(mode, fmt):
    data = pil_bytes(_IMG.convert(mode), "DDS", **({"pixel_format": fmt} if fmt else {}))
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


_BLOCK_FORMATS = {**{fourcc.decode(): dict(fourcc=fourcc, size=size) for fourcc, size in (
    (b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16), (b"ATI1", 8), (b"BC4U", 8), (b"ATI2", 16),
    (b"BC5U", 16), (b"BC5S", 16))},
    **{f"DX10 {code}": dict(fourcc=b"DX10", dxgi=code, size=size) for code, size in (
        (70, 8), (71, 8), (73, 16), (74, 16), (76, 16), (77, 16), (79, 8), (80, 8), (82, 16),
        (83, 16), (84, 16), (95, 16), (96, 16), (97, 16), (98, 16), (99, 16))}}


@pytest.mark.parametrize("name", list(_BLOCK_FORMATS))
def test_random_blocks_decode_to_pils_pixels_bit_for_bit(name):
    spec = _BLOCK_FORMATS[name]
    w, h = 37, 22                                   # partial blocks at both edges
    rng = np.random.default_rng(52 + len(name))
    body = rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * spec["size"],
                        dtype=np.uint8).tobytes()
    data = dds(w, h, 0x4, spec["fourcc"], body=body, dxgi=spec.get("dxgi"))
    fmt, want = pil_open(data)
    assert fmt == "DDS" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _modal_blocks(dxgi, mode, n, rng):
    """n random blocks of one BC7 mode (8: no mode bit, an invalid block)
    or one BC6H mode value (2 or 5 low bits; 0b10011 and 0b11111 reserved)."""
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    low = blocks[:, 0].astype(np.int64)
    if dxgi >= 97:
        low = (low & ~((2 << mode) - 1) | (1 << mode)) if mode < 8 else low * 0
    else:
        bits = 2 if mode < 2 else 5
        low = low & ~((1 << bits) - 1) | mode
    blocks[:, 0] = low & 0xFF
    return blocks


_BC6H_MODES = (0b00, 0b01, 0b00010, 0b00110, 0b01010, 0b01110, 0b10010, 0b10110, 0b11010,
               0b11110, 0b00011, 0b00111, 0b01011, 0b01111, 0b10011, 0b11111)


@pytest.mark.parametrize("dxgi,mode", [(d, m) for d in (95, 96) for m in _BC6H_MODES]
                         + [(d, m) for d in (97, 98, 99) for m in range(9)])
def test_every_bc6h_and_bc7_mode_decodes_to_pils_pixels_bit_for_bit(dxgi, mode):
    """BC6H (unsigned 95, signed 96) by each mode value, reserved ones too,
    and BC7 by each mode and the invalid block: 300 random blocks each."""
    rng = np.random.default_rng(dxgi * 64 + mode)
    w, h = 4 * 20 - 1, 4 * 15 - 2                    # partial blocks at both edges
    data = dds(w, h, 0x4, b"DX10", body=_modal_blocks(dxgi, mode, 300, rng).tobytes(),
               dxgi=dxgi)
    fmt, want = pil_open(data)
    assert fmt == "DDS" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _uncompressed():
    rng = np.random.default_rng(53)
    w, h = 13, 7
    b = lambda n: rng.integers(0, 256, w * h * n, dtype=np.uint8).tobytes()  # noqa: E731
    return {
        "565": dds(w, h, 0x40, bits=16, masks=(0xF800, 0x7E0, 0x1F, 0), body=b(2)),
        "1555 with alpha": dds(w, h, 0x41, bits=16, masks=(0x7C00, 0x3E0, 0x1F, 0x8000),
                               body=b(2)),
        "24-bit BGR": dds(w, h, 0x40, bits=24, masks=(0xFF0000, 0xFF00, 0xFF, 0), body=b(3)),
        "32-bit, odd masks": dds(w, h, 0x41, bits=32, masks=(0x3FF00000, 0xFFC00, 0x3FF, 0),
                                 body=b(4)),
        "a zero mask": dds(w, h, 0x40, bits=32, masks=(0xFF, 0, 0xFF0000, 0), body=b(4)),
        "a body cut short reads zeros": dds(w, h, 0x40, bits=32,
                                            masks=(0xFF0000, 0xFF00, 0xFF, 0), body=b(4)[:99]),
        "pixels of 1000 bytes, a body of 9": dds(w, h, 0x40, bits=8000,
                                                  masks=(0xFF0000, 0xFF00, 0xFF, 0),
                                                  body=b(4)[:9]),
        "8-bit luminance": dds(w, h, 0x20000, bits=8, body=b(1)),
        "luminance and alpha": dds(w, h, 0x20001, bits=16, body=b(2)),
        "8-bit palette": dds(w, h, 0x20, bits=8, body=b(1024 // (w * h) + 1)[:1024] + b(1)),
        "DX10 R8G8B8A8": dds(w, h, 0x4, b"DX10", body=b(4), dxgi=28),
    }


@pytest.mark.parametrize("name", list(_uncompressed()))
def test_uncompressed_ddss_decode_to_pils_pixels(name):
    data = _uncompressed()[name]
    fmt, want = pil_open(data)
    assert fmt == "DDS" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _refused():
    block = bytes(16)
    return {
        "an unknown FourCC": (dds(4, 4, 0x4, b"ABCD", body=block), "ABCD"),
        "a DXGI format PIL does not read": (dds(4, 4, 0x4, b"DX10", body=block, dxgi=2), "DXGI"),
        "16-bit luminance": (dds(4, 4, 0x20000, bits=16, body=bytes(32)), "luminance"),
        "no pixel format flag": (dds(4, 4, 0x0, body=block), "flags"),
        "a header of 120": (b"DDS " + struct.pack("<I", 120) + bytes(150), "header size"),
        "blocks cut short": (dds(8, 8, 0x4, b"DXT1", body=bytes(31)), "truncated"),
        "luminance cut short": (dds(4, 4, 0x20000, bits=8, body=bytes(15)), "truncated"),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_pil_refuses_is_refused_by_name(name):
    data, word = _refused()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match=f"DDS.*{word}"):
        codecs.decode(data)
