"""The port's PSD decoder (data/psd.py) against PIL 12's: PIL writes no
PSD, so each stream is built here (header, colour-mode data, resources, a
layer section, the merged image raw or in PackBits); the port's pixels
equal PIL's `convert("RGB")` exactly, and where PIL refuses a body the
port raises ValueError.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_psd.py
"""

import struct

import numpy as np
import pytest

from shmgan_tpu_torch.data import codecs
from torch_format_streams import pil_open, psd

_H, _W = 17, 26


def _planes(c, seed, row=_W):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (c, _H, row), dtype=np.uint8)
    p[:, 3:9, 2:20 if row > 20 else row] = 77            # runs for PackBits
    return p


def _streams():
    palette = np.random.default_rng(9).integers(0, 256, 768, dtype=np.uint8).tobytes()
    cases = {
        "bitmap": dict(planes=_planes(1, 1, row=(_W + 7) // 8), colour=0, bits=1),
        "grey": dict(planes=_planes(1, 2), colour=1),
        "grey, mode 0": dict(planes=_planes(1, 3), colour=0),
        "duotone": dict(planes=_planes(1, 4), colour=8, colour_data=b"duotone spec" * 5),
        "multichannel": dict(planes=_planes(3, 5), colour=7),
        "indexed": dict(planes=_planes(1, 6), colour=2, colour_data=palette),
        "indexed, no palette": dict(planes=_planes(1, 7), colour=2),
        "RGB": dict(planes=_planes(3, 8), colour=3),
        "RGBA": dict(planes=_planes(4, 9), colour=3),
        "RGB, five channels": dict(planes=_planes(5, 10), colour=3),
        "CMYK": dict(planes=_planes(4, 11), colour=4),
        "CMYK and alpha": dict(planes=_planes(5, 12), colour=4),
        "Lab": dict(planes=_planes(3, 13), colour=9),
        "RGB, resources and layers": dict(
            planes=_planes(3, 14), colour=3,
            resources=[(1005, b"", b"\x00" * 16), (1039, b"icc", b"profile bytes"),
                       (1028, b"ab", b"\x01\x02\x03")],
            layers=struct.pack(">I", 0) + b"\x00" * 8),
    }
    return {f"{name}, {'PackBits' if comp else 'raw'}": psd(compression=comp, **kw)
            for name, kw in cases.items() for comp in (0, 1)}


@pytest.mark.parametrize("name", list(_streams()))
def test_psds_decode_to_pils_pixels(name):
    data = _streams()[name]
    fmt, want = pil_open(data)
    assert fmt == "PSD" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _refused():
    grey = _planes(1, 20)
    return {
        "16 bits": (psd(np.zeros((3, 2, 8), np.uint8), 3, bits=16), "16 bits"),
        "32 bits": (psd(np.zeros((1, 2, 8), np.uint8), 1, bits=32), "32 bits"),
        "too few channels": (psd(grey, 3, channels=2), "channels"),
        "compression 2": (psd(grey, 1, compression=0)[:-grey.size - 2] + b"\x00\x02"
                          + grey.tobytes(), "compression 2"),
        # the run's bytes past the first row are dropped, and the second row is missing
        "a packet across a row": (psd(np.zeros((1, 2, 3), np.uint8), 1)[:-6 - 2] + b"\x00\x01"
                                  + struct.pack(">HH", 2, 2) + bytes([0xFB, 7]), "truncated"),
        "truncated raw": (psd(grey, 1)[:-5], "truncated"),
        "truncated PackBits": (psd(grey, 1, compression=1)[:-5], "truncated"),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_pil_refuses_is_refused(name):
    data, word = _refused()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match=f"PSD.*{word}"):
        codecs.decode(data)


@pytest.mark.parametrize("body", [[0xFC, 7, 0xFE, 9], [4, 1, 2, 3, 4, 5, 2, 6, 8, 9],
                                  [0x80, 0xFB, 7, 0x80, 0xFD, 3]],
                         ids=["run", "literal", "no-ops"])
def test_packbits_past_a_rows_end_is_dropped_as_pil_drops_it(body):
    data = psd(np.zeros((1, 2, 3), np.uint8), 1)[:-6 - 2] + b"\x00\x01" + struct.pack(
        ">HH", 2, 2) + bytes(body)
    fmt, want = pil_open(data)
    assert fmt == "PSD" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def test_a_header_pil_does_not_take_is_unrecognised():
    data = b"8BPS" + bytes(40)                           # version 0
    assert pil_open(data)[0] is None
    with pytest.raises(ValueError, match="unrecognised"):
        codecs.decode(data)


def test_every_cut_of_a_psd_is_refused_with_value_error():
    data = psd(_planes(3, 21), 3, compression=1, resources=[(1005, b"", bytes(16))])
    for cut in range(4, len(data), 29):
        with pytest.raises(ValueError):
            codecs.decode(data[:cut])
