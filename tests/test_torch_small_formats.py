"""The port's QOI, PCX/DCX, SGI, PFM, MSP and XBM decoders against PIL 12's:
streams PIL writes, and streams built here where PIL writes none (QOI
ops and a never-written index slot, EGA and padded PCX, DCX, SGI RLE and
16-bit, MSP v2, XBM headers and hex lists); the port's pixels equal PIL's
`convert("RGB")` exactly, and where PIL refuses a body the port raises
ValueError.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_small_formats.py
"""

import struct

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs
from torch_format_streams import msp_v2, photo, pil_bytes, pil_open, pil_rgb, sgi

_IMG = Image.fromarray(photo(21, 30, seed=41))


def _pil_image(mode):
    return _IMG.quantize(50) if mode == "P" else _IMG.convert(mode)


def _pil_written():
    return {
        "QOI RGB": pil_bytes(_pil_image("RGB"), "QOI"),
        "QOI RGBA": pil_bytes(_pil_image("RGBA"), "QOI"),
        "PCX RGB": pil_bytes(_pil_image("RGB"), "PCX"),
        "PCX L": pil_bytes(_pil_image("L"), "PCX"),
        "PCX P": pil_bytes(_pil_image("P"), "PCX"),
        "PCX 1": pil_bytes(_pil_image("1"), "PCX"),
        "SGI RGB": pil_bytes(_pil_image("RGB"), "SGI"),
        "SGI RGBA": pil_bytes(_pil_image("RGBA"), "SGI"),
        "SGI L": pil_bytes(_pil_image("L"), "SGI"),
        "PFM": pil_bytes(Image.fromarray((photo(21, 30, seed=42)[..., 0].astype(np.float32)
                                          * 1.3 - 40.5)), "PPM"),
        "MSP": pil_bytes(_pil_image("1"), "MSP"),
        "XBM": pil_bytes(_pil_image("1"), "XBM"),
        "XBM with a hotspot": pil_bytes(_pil_image("1"), "XBM", hotspot=(3, 4)),
    }


@pytest.mark.parametrize("name", list(_pil_written()))
def test_pil_written_streams_decode_to_pils_pixels(name):
    data = _pil_written()[name]
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


# -- QOI ----------------------------------------------------------------------------

def _qoi(w, h, ops, channels=3):
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + bytes(ops) + bytes(7) + b"\x01"


def _qois():
    rng = np.random.default_rng(43)
    ops = []
    for _ in range(60):                 # every op, random arguments
        kind = rng.integers(0, 6)
        if kind == 0:
            ops += [0xFE] + list(rng.integers(0, 256, 3))
        elif kind == 1:
            ops += [0xFF] + list(rng.integers(0, 256, 4))
        elif kind == 2:
            ops += [int(rng.integers(0, 64))]                   # INDEX, seen or not
        elif kind == 3:
            ops += [int(rng.integers(0x40, 0x80))]              # DIFF
        elif kind == 4:
            ops += [int(rng.integers(0x80, 0xC0)), int(rng.integers(0, 256))]   # LUMA
        else:
            ops += [int(rng.integers(0xC0, 0xFE))]              # RUN, up to 62
    return {
        "every op, RGB": _qoi(17, 16, ops * 12),
        "every op, RGBA": _qoi(17, 16, ops * 12, channels=4),
        "five channels (PIL's RGBA)": _qoi(17, 16, ops * 12, channels=5),
        "an index never written": _qoi(2, 1, [0x05, 0x3F]),
        "a run past the end": _qoi(3, 1, [0xFE, 1, 2, 3, 0xFD]),
    }


@pytest.mark.parametrize("name", list(_qois()))
def test_hand_made_qois_decode_to_pils_pixels(name):
    data = _qois()[name]
    fmt, want = pil_open(data)
    assert fmt == "QOI" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


@pytest.mark.parametrize("ops", [[0xFE, 1, 2], [0xFF, 1, 2, 3], [0x85], [0x00]],
                         ids=["rgb", "rgba", "luma", "short"])
def test_a_qoi_cut_short_is_refused(ops):
    data = _qoi(2, 1, ops)[:14 + len(ops)]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match="QOI"):
        codecs.decode(data)


# -- PCX, DCX -----------------------------------------------------------------------

def _pcx_rle(lines):
    out = bytearray()
    for line in lines:
        i = 0
        while i < len(line):
            j = i
            while j + 1 < len(line) and j - i < 62 and line[j + 1] == line[i]:
                j += 1
            if j > i or line[i] >= 0xC0:
                out += bytes([0xC0 | (j - i + 1), line[i]])
            else:
                out.append(line[i])
            i = j + 1
    return bytes(out)


def _pcx(w, h, bits, planes, lines, stride=None, version=5, palette16=None, tail=b""):
    stride = stride if stride is not None else (w * bits + 7) // 8
    pal = bytes(48) if palette16 is None else bytes(palette16)
    head = (bytes([10, version, 1, bits]) + struct.pack("<HHHHHH", 2, 5, w + 1, h + 4, 72, 72)
            + pal + bytes([0, planes]) + struct.pack("<HH", stride, 1) + bytes(58))
    return head + _pcx_rle(lines) + tail


def _pcxs():
    rng = np.random.default_rng(44)
    w, h = 21, 11
    pal16 = rng.integers(0, 256, 48, dtype=np.uint8)
    plane = (w + 7) // 8
    ega4 = [bytes(rng.integers(0, 256, 4 * plane, dtype=np.uint8)) for _ in range(h)]
    ega2 = [bytes(rng.integers(0, 256, 2 * plane, dtype=np.uint8)) for _ in range(h)]
    grey = [bytes(rng.integers(0, 256, w + 1, dtype=np.uint8)) for _ in range(h)]
    rgb = [bytes(rng.integers(0, 256, 3 * (w + 1), dtype=np.uint8)) for _ in range(h)]
    palette = b"\x0c" + rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    ramp = b"\x0c" + bytes(v for i in range(256) for v in (i, i, i))
    out = {
        "EGA, 4 planes": _pcx(w, h, 1, 4, ega4, palette16=pal16),
        "EGA, 2 planes, version 2": _pcx(w, h, 1, 2, ega2, palette16=pal16, version=2),
        "8-bit, odd width padded": _pcx(w, h, 8, 1, grey, stride=w + 1),
        "8-bit, 256 colours": _pcx(w, h, 8, 1, grey, stride=w + 1, tail=palette),
        "8-bit, the grey ramp": _pcx(w, h, 8, 1, grey, stride=w + 1, tail=ramp),
        "24-bit as 3 padded planes": _pcx(w, h, 8, 3, rgb, stride=w + 1),
        "1-bit, version 0": _pcx(w, h, 1, 1, [bytes(rng.integers(0, 256, 4, dtype=np.uint8))
                                              for _ in range(h)], stride=4, version=0),
    }
    page = out["8-bit, 256 colours"]
    out["DCX, its first page"] = (struct.pack("<III", 0x3ADE68B1, 16, 16 + len(page))
                                  + bytes(4) + page + out["EGA, 4 planes"])
    return out


@pytest.mark.parametrize("name", list(_pcxs()))
def test_hand_made_pcxs_decode_to_pils_pixels(name):
    data = _pcxs()[name]
    fmt, want = pil_open(data)
    assert fmt in ("PCX", "DCX") and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _bad_pcxs():
    return {
        "a run across a line": _pcx(3, 2, 8, 1, []) + bytes([0xC4, 7, 0xC2, 9]),
        "4-bit": _pcx(3, 2, 4, 1, [bytes(2), bytes(2)]),
        "8-bit, version 3": _pcx(3, 2, 8, 1, [bytes(3), bytes(3)], version=3),
        "truncated": _pcx(21, 11, 8, 1, [bytes(range(22))] * 11)[:-40],
    }


@pytest.mark.parametrize("name", list(_bad_pcxs()))
def test_what_pil_refuses_in_a_pcx_is_refused(name):
    data = _bad_pcxs()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match="PCX"):
        codecs.decode(data)


def test_pcx_runs_over_a_long_body_of_empty_runs():
    """Runs of count 0 write nothing: the decoder reads on past twice the
    image's bytes when the body holds them."""
    line = bytes(range(10, 31))
    data = _pcx(21, 2, 8, 1, []) + b"\xc0\x05" * 100 + _pcx_rle([line, line])
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


# -- SGI ----------------------------------------------------------------------------

def _sgis():
    rng = np.random.default_rng(45)
    out = {}
    for z in (1, 3, 4):
        for bpc in (1, 2):
            planes = rng.integers(0, 256 ** bpc, (z, 9, 13)).astype(np.uint16)
            planes[:, 2:5, 3:11] = planes[:, 2:3, 3:4]             # runs for the RLE
            for rle in (False, True):
                out[f"{z} channels, {8 * bpc} bits, {'RLE' if rle else 'raw'}"] = sgi(
                    planes, bpc, rle)
    out["grey, dimension 1"] = sgi(rng.integers(0, 256, (1, 1, 13)), 1, dim=1)
    return out


@pytest.mark.parametrize("name", list(_sgis()))
def test_hand_made_sgis_decode_to_pils_pixels(name):
    data = _sgis()[name]
    fmt, want = pil_open(data)
    assert fmt == "SGI" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _bad_sgis():
    good = sgi(np.arange(3 * 4 * 5).reshape(3, 4, 5) % 256, 1, rle=True)
    return {
        "two channels": (sgi(np.zeros((2, 3, 3), np.uint8), 1), "2 channels"),
        "storage 2": (good[:2] + b"\x02" + good[3:], "storage 2"),
        "a row past the file": (good[:-3], "past"),
        "truncated raw": (sgi(np.zeros((3, 3, 3), np.uint8), 1)[:-4], "truncated"),
    }


@pytest.mark.parametrize("name", list(_bad_sgis()))
def test_what_pil_refuses_in_an_sgi_is_refused(name):
    data, word = _bad_sgis()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match=f"SGI.*{word}"):
        codecs.decode(data)


# -- PFM ----------------------------------------------------------------------------

def _pfm(values, scale, header=None):
    values = np.asarray(values, np.float32)
    h, w = values.shape
    head = header or b"Pf\n%d %d\n%s\n" % (w, h, repr(scale).encode())
    return head + values[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


def _pfms():
    v = np.array([[0.6, 254.5, 300.0, -0.6, np.nan], [np.inf, -np.inf, 128.99, 1e10, 17.0]])
    return {
        "little-endian, clipped and truncated": _pfm(v, -1.0),
        "big-endian, scale 2.5": _pfm(v, 2.5),
        "comments and spaces in the header": _pfm(v, -1.0, b"Pf # c\n 5\t2 #x\n-1.0\n"),
    }


@pytest.mark.parametrize("name", list(_pfms()))
def test_pfms_decode_to_pils_pixels(name):
    data = _pfms()[name]
    fmt, want = pil_open(data)
    assert fmt == "PPM" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


@pytest.mark.parametrize("data", [b"PF\n1 1\n-1.0\n" + bytes(12), b"Pf\n1 1\n0.0\n" + bytes(4),
                                  b"Pf\n1 1\nnan\n" + bytes(4), b"Pf\n2 2\n-1.0\n" + bytes(12)],
                         ids=["colour PF", "scale 0", "scale nan", "truncated"])
def test_what_pil_refuses_in_a_pfm_is_refused(data):
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError):
        codecs.decode(data)


# -- MSP, XBM -----------------------------------------------------------------------

def test_an_msp_v2_decodes_to_pils_pixels():
    rng = np.random.default_rng(46)
    rows = rng.integers(0, 256, (13, 3), dtype=np.uint8)
    rows[2:5] = 0xFF                                            # blank rows
    rows[6, :] = 0x0F
    data = msp_v2(rows)
    fmt, want = pil_open(data)
    assert fmt == "MSP" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def test_a_bad_msp_checksum_is_not_msp():
    data = bytearray(pil_bytes(_pil_image("1"), "MSP"))
    data[30] ^= 1
    assert pil_open(bytes(data))[0] is None
    with pytest.raises(ValueError, match="unrecognised"):
        codecs.decode(bytes(data))


@pytest.mark.parametrize("body", [
    b"#define a_width 10\n#define a_height 2\nstatic char a_bits[] = {\n0x01, 0x80, 0xff, 0x03};",
    b"  #define a_width 9\r\n#define a_height 2\r\n#define a_x_hot 1\r\n#define a_y_hot 0\r\n"
    b"static unsigned char a_bits[] = { 0xG1, 0XA1 x1z x0f x80 };\n",
    b"#define b_width 3\n#define b_height 1\nchar b_bits[] = {0xAb}; b_bits[] = {0x01};",
], ids=["plain", "hotspot, odd hex", "two bits arrays"])
def test_hand_made_xbms_decode_to_pils_pixels(body):
    fmt, want = pil_open(body)
    assert fmt == "XBM" and want is not None
    np.testing.assert_array_equal(codecs.decode(body), want)


def test_an_xbm_cut_short_is_refused():
    data = b"#define a_width 16\n#define a_height 2\nstatic char a_bits[] = {0x01, 0x02, 0x0"
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError, match="XBM"):
        codecs.decode(data)
