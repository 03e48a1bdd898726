"""The port's ICO, CUR and ICNS decoders (data/icons.py) against PIL 12's:
ICOs PIL writes (PNG entries, and BMP entries with bitmap_format="bmp"),
and ICOs, CURs and ICNS entries built here (DIB entries at 1, 4, 8, 24
and 32 bits with their AND masks, the entry PIL picks among several, the
24-bit ICNS entries raw and run-length coded with their masks, a JPEG 2000
entry); the port's pixels equal PIL's `convert("RGB")` exactly, and where
PIL refuses a body the port raises ValueError.

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_icons.py
"""

import functools

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs
from torch_format_streams import dib, icns, icns_rle, icon_dir, photo, pil_bytes, pil_open, pil_rgb

_IMG = Image.fromarray(photo(48, 48, seed=31))


def _pil_image(mode):
    return _IMG.quantize(60) if mode == "P" else _IMG.convert(mode)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P", "1"])
@pytest.mark.parametrize("entries", ["png", "bmp"])
def test_pil_written_icos_decode_to_pils_pixels(mode, entries):
    kw = {"bitmap_format": "bmp"} if entries == "bmp" else {}
    data = pil_bytes(_pil_image(mode), "ICO", sizes=[(16, 16), (24, 24), (48, 48)], **kw)
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


def _dib_entry(bits, h=13, w=21, seed=0):
    rng = np.random.default_rng(seed)
    if bits <= 8:
        idx = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        body = dib(idx, bits, palette)
    else:
        body = dib(rng.integers(0, 256, (h, w, bits // 8), dtype=np.uint8), bits)
    return w, h, bits, body


def _icos():
    return {
        **{f"{bits}-bit DIB": icon_dir(1, [_dib_entry(bits, seed=bits)]) for bits in
           (1, 4, 8, 24, 32)},
        "the largest of three": icon_dir(1, [_dib_entry(8, 9, 9, 1), _dib_entry(24, 13, 21, 2),
                                             _dib_entry(4, 11, 11, 3)]),
        "fewest bits among equals": icon_dir(1, [_dib_entry(32, 13, 21, 4),
                                                 _dib_entry(8, 13, 21, 5),
                                                 _dib_entry(24, 13, 21, 6)]),
        "a PNG beside DIBs": icon_dir(1, [_dib_entry(24, 9, 9, 7), (
            32, 32, 32, pil_bytes(Image.fromarray(photo(32, 32, seed=8)), "PNG"))]),
    }


@pytest.mark.parametrize("name", list(_icos()))
def test_hand_made_icos_decode_to_pils_pixels(name):
    data = _icos()[name]
    fmt, want = pil_open(data)
    assert fmt == "ICO" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


@pytest.mark.parametrize("bits", [1, 8, 24])
@pytest.mark.parametrize("cut", [1, 2])
def test_an_ico_entry_whose_mask_is_cut_short_is_refused(bits, cut):
    """The mask's last row of a 21-wide entry holds 3 bytes and 1 of padding,
    which PIL does not read: a file one byte short decodes, two do not."""
    data = icon_dir(1, [_dib_entry(bits, seed=9)])[:-cut]
    fmt, want = pil_open(data)
    if cut == 1:
        assert fmt == "ICO"
        np.testing.assert_array_equal(codecs.decode(data), want)
    else:
        assert want is None
        with pytest.raises(ValueError, match="ICO"):
            codecs.decode(data)


def _curs():
    return {
        **{f"{bits}-bit": icon_dir(2, [_dib_entry(bits, seed=10 + bits)]) for bits in
           (1, 4, 8, 24, 32)},
        "the larger in both": icon_dir(2, [_dib_entry(8, 9, 9, 11), _dib_entry(24, 13, 21, 12),
                                           _dib_entry(24, 17, 11, 13)]),
        "no mask": icon_dir(2, [(21, 13, 24, _dib_entry(24, seed=14)[3][:-13 * 4])]),
    }


@pytest.mark.parametrize("name", list(_curs()))
def test_hand_made_curs_decode_to_pils_pixels(name):
    data = _curs()[name]
    fmt, want = pil_open(data)
    assert fmt == "CUR" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


@functools.lru_cache(maxsize=1)
def _pil_icns():
    """One PIL-written ICNS: every size up to 1024 x 1024, as PNGs."""
    return pil_bytes(Image.fromarray(photo(40, 40, seed=15)), "ICNS")


def test_a_pil_written_icns_decodes_to_pils_pixels():
    data = _pil_icns()
    np.testing.assert_array_equal(codecs.decode(data), pil_rgb(data))


def _rgb_entries(side, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    rgb[side // 4:side // 2] = rgb[side // 4, 0]                # runs for the RLE
    mask = rng.integers(0, 256, side * side, dtype=np.uint8).tobytes()
    raw = rgb.tobytes()
    rle = b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3))
    return raw, rle, mask


def _icnss():
    out = {}
    for kind, mk, side in ((b"is32", b"s8mk", 16), (b"il32", b"l8mk", 32),
                           (b"ih32", b"h8mk", 48), (b"it32", b"t8mk", 128)):
        raw, rle, mask = _rgb_entries(side, side)
        lead = b"\x00\x00\x00\x00" if kind == b"it32" else b""
        out[f"{kind.decode()} raw"] = icns([(kind, lead + raw), (mk, mask)])
        out[f"{kind.decode()} RLE"] = icns([(kind, lead + rle), (mk, mask)])
    small_raw, _, small_mask = _rgb_entries(16, 1)
    _, big_rle, _ = _rgb_entries(48, 2)
    out["the largest size"] = icns([(b"is32", small_raw), (b"s8mk", small_mask),
                                    (b"ih32", big_rle)])
    png = pil_bytes(Image.fromarray(photo(32, 32, seed=16)), "PNG")
    out["a PNG entry"] = icns([(b"is32", small_raw), (b"icp5", png)])
    jp2 = pil_bytes(Image.fromarray(photo(64, 64, seed=17)), "JPEG2000", irreversible=False)
    out["a JPEG 2000 entry"] = icns([(b"icp6", jp2), (b"is32", small_raw)])
    return out


@pytest.mark.parametrize("name", list(_icnss()))
def test_hand_made_icns_decode_to_pils_pixels(name):
    data = _icnss()[name]
    fmt, want = pil_open(data)
    assert fmt == "ICNS" and want is not None
    np.testing.assert_array_equal(codecs.decode(data), want)


def _bad_icnss():
    raw, rle, mask = _rgb_entries(16, 3)
    planes = np.frombuffer(raw, np.uint8).reshape(256, 3).T
    overfilled = (icns_rle(planes[0].tobytes()) + b"\x83\x07" + icns_rle(planes[1].tobytes())
                  + icns_rle(planes[2].tobytes()))
    return {
        "RLE that overfills": icns([(b"is32", overfilled)]),
        "a mask cut short": icns([(b"is32", raw), (b"s8mk", mask[:-1])]),
        "raw cut short": icns([(b"is32", raw)])[:-5],
        "it32 without its zero word": icns([(b"it32", _rgb_entries(128, 4)[1])]),
        "a mask alone": icns([(b"s8mk", mask)]),
        "an unknown entry": icns([(b"icp4", b"not an image at all")]),
    }


@pytest.mark.parametrize("name", list(_bad_icnss()))
def test_what_pil_refuses_in_an_icns_is_refused(name):
    data = _bad_icnss()[name]
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError):
        codecs.decode(data)


@pytest.mark.parametrize("data", [
    b"\x00\x00\x01\x00\x00\x00" + bytes(40),      # an ICO of no entries
    b"\x00\x00\x01\x00\x05\x00" + bytes(30),      # a directory cut short
    b"icns\x00\x00\x00\x40" + bytes(8),           # a block of size 0
    b"icns\x00\x00\x00\x10iXXX\x00\x00\x00\x08",  # no icon resource
], ids=["ico empty", "ico cut directory", "icns block 0", "icns no resource"])
def test_icon_headers_pil_passes_on_are_not_taken(data):
    assert pil_open(data)[1] is None
    with pytest.raises(ValueError):
        codecs.decode(data)
