"""JPEG 2000 streams that real encoders write and PIL's save options never
do, decoded by the port (data/jpeg2000.py, csrc/jpeg2000_t1.cc) to PIL's
`convert("RGB")` pixels exactly: every code-block style (BYPASS, RESET,
TERMALL, VSC, PTERM, SEGSYM) alone and together, SOP and EPH markers,
sub-sampled components under sYCC, an unspecified colour space and sRGB,
RGN's max-shift, POC, packet headers moved into PPM and PPT, CRG; the C++
tier 1 held to the plain version bit for bit on every code-block; what PIL
refuses refused too, and what the port still does not decode refused by
name.

The streams are written at test time by the openjpeg PIL ships, through
ctypes (tests/_opj_encode.py), at 16x16 to 48x32, or rewritten here from
them (POC, PPM, PPT, CRG)."""

import io
import re
import struct

import numpy as np
import pytest
from PIL import Image

from _opj_encode import encode
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data import jpeg2000 as j2k

FULL = ((1, 1, 1), (1, 1, 1))
SUB = {"4:2:0": ((1, 2, 2), (1, 2, 2)), "4:2:2": ((1, 2, 2), (1, 1, 1)),
       "4:4:0": ((1, 1, 1), (1, 2, 2))}


def _planes(w, h, dx, dy, seed=0, offset=(0, 0)):
    """Smooth, noisy 8-bit planes, each at its component's size."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (a, b) in enumerate(zip(dx, dy)):
        ph = -(-(h + offset[1]) // b) + (-offset[1] // b)
        pw = -(-(w + offset[0]) // a) + (-offset[0] // a)
        yy, xx = np.mgrid[0:ph, 0:pw]
        v = 128 + 90 * np.sin(xx / (3.0 + i) + yy / 5.0) + rng.normal(0, 12, (ph, pw))
        out.append(np.clip(v, 0, 255).astype(np.uint8))
    return out


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


# -- codestream rewrites -----------------------------------------------------------------

def _segment(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _codestream(data):
    """The jp2c box's codestream of a JP2 file (a raw codestream as it is)."""
    if data[:4] == j2k.J2K_SIGNATURE:
        return data
    i = data.index(b"jp2c")
    return data[i + 4:]


def _colr(data, enum):
    """A JP2 file with its colr box's enumerated colour space set to `enum`."""
    i = data.index(b"colr")
    return data[:i + 4] + struct.pack(">BBBI", 1, 0, 0, enum) + data[i + 11:]


def _main_header_end(cs):
    return cs.index(b"\xff\x90")


def _in_main_header(cs, segments):
    i = _main_header_end(cs)
    return cs[:i] + segments + cs[i:]


def _tile_parts(cs):
    """[(header markers, data)] of each tile-part, with its Isot, TPsot, TNsot."""
    out, pos = [], _main_header_end(cs)
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[pos + 4:pos + 12])
        part = cs[pos:pos + psot]
        sod = part.index(b"\xff\x93")
        out.append(((isot, tpsot, tnsot), part[12:sod], part[sod + 2:]))
        pos += psot
    return out


def _joined(cs, parts):
    """A codestream of cs's main header and `parts` [(sot, markers, data)]."""
    out = cs[:_main_header_end(cs)]
    for (isot, tpsot, tnsot), markers, data in parts:
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, 14 + len(markers) + len(data), tpsot,
                           tnsot) + markers + b"\xff\x93" + data
    return out + b"\xff\xd9"


def _packets(data):
    """[(SOP, header up to and with EPH, body)] of tile-part data written
    with SOP and EPH markers (neither pair can occur in stuffed bytes)."""
    starts = []
    i = data.find(b"\xff\x91\x00\x04")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\xff\x91\x00\x04", i + 6)
    assert starts and starts[0] == 0
    out = []
    for a, b in zip(starts, starts[1:] + [len(data)]):
        packet = data[a:b]
        eph = packet.index(b"\xff\x92", 6) + 2
        out.append((packet[:6], packet[6:eph], packet[eph:]))
    return out


def _with_ppt(cs, split=False):
    """Each tile-part's packet headers moved into PPT segments of its header
    (two, Zppt 1 before Zppt 0, when `split`)."""
    parts = []
    for sot, markers, data in _tile_parts(cs):
        packets = _packets(data)
        headers = b"".join(h for _, h, _ in packets)
        if split:
            cut = len(headers) // 3
            ppt = (_segment(0xFF61, b"\x01" + headers[cut:])
                   + _segment(0xFF61, b"\x00" + headers[:cut]))
        else:
            ppt = _segment(0xFF61, b"\x00" + headers)
        parts.append((sot, markers + ppt, b"".join(s + b for s, _, b in packets)))
    return _joined(cs, parts)


def _with_ppm(cs):
    """Every tile-part's packet headers moved into two PPM segments of the
    main header (an Nppm and its headers running from the first into the
    second)."""
    parts, ippm = [], b""
    for sot, markers, data in _tile_parts(cs):
        packets = _packets(data)
        headers = b"".join(h for _, h, _ in packets)
        ippm += struct.pack(">I", len(headers)) + headers
        parts.append((sot, markers, b"".join(s + b for s, _, b in packets)))
    cut = 4 + len(ippm) // 2
    ppm = _segment(0xFF60, b"\x00" + ippm[:cut]) + _segment(0xFF60, b"\x01" + ippm[cut:])
    return _joined(_in_main_header(cs, ppm), parts)


def _poc(*entries):
    """A POC segment: (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc) each."""
    return _segment(0xFF5F, b"".join(struct.pack(">BBHBBB", *e) for e in entries))


def _in_first_tile_part(cs, segment):
    """`segment` put in the first tile-part's header."""
    parts = _tile_parts(cs)
    sot, markers, data = parts[0]
    return _joined(cs, [(sot, markers + segment, data)] + parts[1:])


def _crg(cs, nc=3):
    i = cs.index(b"\xff\x52")
    return cs[:i] + _segment(0xFF63, b"".join(struct.pack(">HH", 7 * k, 3 * k)
                                              for k in range(nc))) + cs[i:]


# -- the streams ---------------------------------------------------------------------------

STYLES = {"BYPASS": 0x01, "RESET": 0x02, "TERMALL": 0x04, "VSC": 0x08, "PTERM": 0x10,
          "SEGSYM": 0x20, "all six": 0x3F, "BYPASS|TERMALL": 0x05, "BYPASS|RESET": 0x03}


def _style_streams():
    out = {}
    for name, style in STYLES.items():
        out[f"{name} jp2 5/3 3 layers"] = encode(
            _planes(48, 32, *FULL, seed=style), *FULL, style=style, numres=2, rates=(12, 4, 0))
        out[f"{name} j2k 9/7 2 layers"] = encode(
            _planes(32, 24, *FULL, seed=style + 1), *FULL, fmt="j2k", style=style, numres=3,
            cblk=(32, 32), irreversible=True, rates=(16, 5))
    return out


def _packet_streams():
    p = _planes(32, 24, *FULL, seed=70)
    return {
        "SOP": encode(p, *FULL, sop=True, rates=(10, 0)),
        "EPH": encode(p, *FULL, eph=True, rates=(10, 0)),
        "SOP and EPH": encode(p, *FULL, sop=True, eph=True, rates=(10, 0)),
        "SOP and EPH j2k 9/7 all styles": encode(p, *FULL, fmt="j2k", sop=True, eph=True,
                                                  style=0x3F, irreversible=True, rates=(9, 3)),
    }


def _subsampled_streams():
    out = {}
    for k, (name, sub) in enumerate(SUB.items()):
        jp2 = encode(_planes(24, 16, *sub, seed=80 + k), *sub, colour="sycc")
        out[f"{name} sYCC"] = jp2
        out[f"{name} colr 0"] = _colr(jp2, 0)
        out[f"{name} sRGB"] = _colr(jp2, 16)
        out[f"{name} raw 9/7"] = encode(_planes(24, 16, *sub, seed=90 + k), *sub, fmt="j2k",
                                        irreversible=True, rates=(6, 2))
    sub = SUB["4:2:0"]
    # odd tiles: Pillow's unpacker reads past a component's rows into zeros
    out["4:2:0 41x29 odd tiles and offsets"] = encode(
        _planes(41, 29, *sub, seed=95, offset=(3, 4)), *sub, tiles=(15, 11, 1, 2), offset=(3, 4),
        size=(41, 29), colour="sycc")
    out["4:2:0 sYCC styles SOP EPH 16x16"] = encode(
        _planes(16, 16, *sub, seed=96), *sub, colour="sycc", style=0x3F, sop=True, eph=True)
    quad = ((1, 2, 2, 1), (1, 2, 2, 1))
    out["4:2:0 and alpha sYCC"] = encode(_planes(24, 16, *quad, seed=97), *quad, colour="sycc")
    out["4:2:0 precincts CPRL 9/7"] = encode(
        _planes(40, 30, *sub, seed=98), *sub, prog="CPRL", tiles=(24, 20, 0, 0),
        precincts=[(16, 16), (8, 8)], size=(40, 30), irreversible=True, rates=(10, 2))
    # the colour transform flagged on components of as many samples in other
    # shapes: openjpeg runs it over their samples in order
    odd = ((2, 1, 2), (1, 2, 1))
    cs = encode(_planes(24, 24, *odd, seed=99), *odd, fmt="j2k")
    i = cs.index(b"\xff\x52")
    out["MCT over equal counts of other shapes"] = cs[:i + 8] + b"\x01" + cs[i + 9:]
    return out


def _rgn_poc_ppx_crg_streams():
    p = _planes(32, 24, *FULL, seed=100)
    rlcp = encode(p, *FULL, fmt="j2k", prog="RLCP", numres=3)
    lrcp = encode(p, *FULL, fmt="j2k", rates=(20, 6, 0), numres=3)
    tiled = encode(_planes(40, 32, *FULL, seed=101), *FULL, fmt="j2k", sop=True, eph=True,
                   tiles=(24, 16, 0, 0), rates=(8, 0))
    sop_eph = encode(p, *FULL, fmt="j2k", sop=True, eph=True, rates=(12, 4, 0), style=0x3F)
    return {
        "RGN 5/3": encode(p, *FULL, roi=(0, 5)),
        "RGN 9/7 layers": encode(p, *FULL, fmt="j2k", roi=(1, 3), irreversible=True,
                                 rates=(10, 3)),
        "RGN all styles": encode(p, *FULL, fmt="j2k", roi=(2, 9), style=0x3F, rates=(20, 5, 0)),
        # one POC entry of CPRL over COD's LRCP: openjpeg writes the packets in CPRL order
        "POC from openjpeg's encoder": encode(p, *FULL, fmt="j2k", rates=(20, 6, 0),
                                              precincts=[(16, 16)],
                                              pocs=[(0, 0, 3, 3, 3, "CPRL")]),
        # LRCP's three layers restated as three entries, each from layer 0
        # on: a packet is read at its first visit only
        "POC by layers": _in_main_header(lrcp, _poc((0, 0, 1, 3, 3, 1), (0, 0, 2, 3, 3, 0),
                                                     (0, 0, 3, 3, 3, 1))),
        # RLCP restated as RLCP then RPCL (one precinct a resolution: the same order)
        "POC main header": _in_main_header(rlcp, _poc((0, 0, 1, 1, 3, 1), (1, 0, 1, 3, 3, 2))),
        # openjpeg appends a tile-part's POC to the main header's
        "POC main and tile-part": _in_first_tile_part(
            _in_main_header(rlcp, _poc((0, 0, 1, 2, 3, 1))), _poc((2, 0, 1, 3, 3, 1))),
        "PPT": _with_ppt(sop_eph),
        "PPT in two segments": _with_ppt(sop_eph, split=True),
        "PPM": _with_ppm(sop_eph),
        "PPM over tiles": _with_ppm(tiled),
        "CRG": _crg(encode(p, *FULL, fmt="j2k", rates=(8, 0))),
    }


@pytest.fixture(scope="module")
def streams():
    out = {}
    for make in (_style_streams, _packet_streams, _subsampled_streams,
                 _rgn_poc_ppx_crg_streams):
        out.update(make())
    return out


_NAMES = (list(_style_streams()) + list(_packet_streams()) + list(_subsampled_streams())
          + list(_rgn_poc_ppx_crg_streams()))


@pytest.mark.parametrize("name", _NAMES)
def test_decodes_to_pils_pixels(streams, name):
    data = streams[name]
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("name", _NAMES)
def test_cpp_tier1_equals_the_plain_version_on_every_code_block(streams, name):
    blocks = j2k.tier1_inputs(streams[name])
    assert blocks
    native, plain = j2k.tier1(blocks), j2k.tier1(blocks, plain=True)
    for b, got, want in zip(blocks, native, plain):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"{b.comp} {b.res} {b.x0} {b.y0}")


def test_rewritten_streams_keep_the_originals_pixels_in_pil(streams):
    """The POC, PPM, PPT and CRG rewrites restate their source streams:
    PIL decodes each to the source's pixels."""
    p = _planes(32, 24, *FULL, seed=100)
    rlcp = _pil_rgb(encode(p, *FULL, fmt="j2k", prog="RLCP", numres=3))
    lrcp = _pil_rgb(encode(p, *FULL, fmt="j2k", rates=(20, 6, 0), numres=3))
    sop_eph = _pil_rgb(encode(p, *FULL, fmt="j2k", sop=True, eph=True, rates=(12, 4, 0),
                              style=0x3F))
    for name in ("POC main header", "POC main and tile-part"):
        np.testing.assert_array_equal(_pil_rgb(streams[name]), rlcp)
    np.testing.assert_array_equal(_pil_rgb(streams["POC by layers"]), lrcp)
    for name in ("PPT", "PPT in two segments", "PPM"):
        np.testing.assert_array_equal(_pil_rgb(streams[name]), sop_eph)


# -- each feature taken is in its streams and decodes --------------------------------------

def _cod_style(cs):
    i = cs.index(b"\xff\x52")
    return cs[i + 4], cs[i + 12]          # Scod, the code-block style


def _has_marker(cs, marker):
    return struct.pack(">H", marker) in cs[:cs.rindex(b"\xff\x93")]


_FEATURES = {
    **{name: (f"{name} j2k 9/7 2 layers", lambda cs, s=style: _cod_style(cs)[1] == s)
       for name, style in STYLES.items() if "|" not in name and name != "all six"},
    "SOP": ("SOP", lambda cs: _cod_style(cs)[0] & 0x02),
    "EPH": ("EPH", lambda cs: _cod_style(cs)[0] & 0x04),
    "sub-sampled components": ("4:2:2 raw 9/7", lambda cs: cs[42:48] == bytes([7, 1, 1, 7, 2, 1])),
    "sYCC": ("4:2:0 sYCC", lambda cs: True),
    "RGN": ("RGN 5/3", lambda cs: _has_marker(cs, 0xFF5E)),
    "POC": ("POC main and tile-part", lambda cs: _has_marker(cs, 0xFF5F)),
    "PPM": ("PPM", lambda cs: _has_marker(cs, 0xFF60)),
    "PPT": ("PPT", lambda cs: _has_marker(cs, 0xFF61)),
    "CRG": ("CRG", lambda cs: _has_marker(cs, 0xFF63)),
}


@pytest.mark.parametrize("feature", list(_FEATURES))
def test_each_feature_taken_is_no_longer_refused(streams, feature):
    name, present = _FEATURES[feature]
    data = streams[name]
    assert present(_codestream(data)), f"{name} lacks {feature}"
    if feature == "sYCC":
        assert struct.unpack(">I", data[data.index(b"colr") + 7:][:4])[0] == 18
    out = codecs.decode(data)
    assert out.dtype == np.uint8 and out.ndim == 3
    refused = j2k.__doc__.split("Refused with a ValueError that names")[1].split("\n\n")[0]
    assert not re.search(rf"\b{feature.split()[0]}\b", refused), refused


# -- colour: Pillow's rules ------------------------------------------------------------------

@pytest.mark.parametrize("dx,dy", [((1, 1, 2), (1, 1, 1)), ((1, 2, 1), (1, 1, 2)),
                                   ((2, 2, 2), (2, 2, 2)), ((2, 1, 1), (1, 1, 1)),
                                   ((1, 1, 1), (2, 1, 1)), ((1, 3, 3), (1, 3, 3))])
def test_unspecified_colour_follows_pillows_subsampling_rule(dx, dy):
    """Pillow takes an unspecified or unknown colour space on three
    components as sYCC where the first is at full size and the second or
    third is not, as sRGB otherwise."""
    planes = _planes(24, 16, dx, dy, seed=sum(dx) + 7 * sum(dy))
    for data in (_colr(encode(planes, dx, dy), 0), encode(planes, dx, dy, fmt="j2k")):
        np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))


def test_ycbcr_conversion_equals_pils_on_every_value():
    v = np.arange(1 << 24, dtype=np.uint32)
    for chunk in np.split(v, 16):
        ycc = np.stack([chunk >> 16, (chunk >> 8) & 255, chunk & 255], -1).astype(np.uint8)
        want = np.asarray(Image.frombytes("YCbCr", (len(chunk), 1), ycc.tobytes())
                          .convert("RGB"))[0]
        np.testing.assert_array_equal(j2k._ycbcr_to_rgb(ycc), want)


# -- refused as PIL refuses, and what is left refused by name --------------------------------

def _set_mct(cs):
    i = cs.index(b"\xff\x52")
    return cs[:i + 8] + b"\x01" + cs[i + 9:]


def _pil_refuses(data):
    with pytest.raises(OSError):
        _pil_rgb(data)


def _as_pil_refuses():
    sub = SUB["4:2:0"]
    p = _planes(24, 16, *FULL, seed=110)
    plain = encode(p, *FULL, fmt="j2k", rates=(10, 0))
    i = plain.index(b"\xff\x52")
    eph_flag = plain[:i + 4] + bytes([plain[i + 4] | 0x04]) + plain[i + 5:]
    ppm = _in_main_header(plain, _segment(0xFF60, b"\x00" + struct.pack(">I", 0)))
    return {
        "e-sYCC": (_colr(encode(_planes(24, 16, *sub, seed=111), *sub, colour="sycc"), 24),
                   "e-sYCC.*PIL refuses it too"),
        "EPH flagged, none written": (eph_flag, "EPH.*PIL too"),
        "grey sub-sampled": (encode(_planes(24, 16, (2,), (2,), seed=112), (2,), (2,),
                                    fmt="j2k"), "sub-sampled.*PIL refuses it too"),
        "colour transform over unequal components": (_set_mct(encode(
            _planes(24, 16, *sub, seed=113), *sub, fmt="j2k")), "other sizes.*PIL too"),
        "RGN of four bytes": (_in_main_header(plain, _segment(0xFF5E, b"\x00\x00\x03\x00")),
                              "RGN.*refuses it too"),
        "CRG of the wrong size": (_in_main_header(plain, _segment(0xFF63, b"\x00" * 8)),
                                  "CRG.*refuses it too"),
        "CRG in a tile-part header": (_in_first_tile_part(plain, _segment(0xFF63, b"\x00" * 12)),
                                      "CRG.*PIL refuses it too"),
        "PPT after PPM": (_in_first_tile_part(ppm, _segment(0xFF61, b"\x00\x00")),
                          "PPT after PPM"),
    }


@pytest.mark.parametrize("name", list(_as_pil_refuses()))
def test_what_pil_refuses_is_refused_too(name):
    data, word = _as_pil_refuses()[name]
    _pil_refuses(data)
    with pytest.raises(ValueError, match=f"JPEG 2000.*{word}"):
        codecs.decode(data)


def _still_refused():
    p = _planes(24, 16, *FULL, seed=120)
    jp2 = encode(p, *FULL, rates=(10, 0))
    cs = _codestream(jp2)
    i = jp2.index(b"jp2h")
    n = struct.unpack(">I", jp2[i - 4:i])[0]
    bpcc = jp2[:i - 4] + struct.pack(">I", n + 11) + jp2[i:i - 4 + n] + \
        struct.pack(">I", 11) + b"bpcc\x07\x07\x07" + jp2[i - 4 + n:]
    tiled = encode(p, *FULL, fmt="j2k", tiles=(12, 8, 0, 0))
    last = _tile_parts(tiled)
    k = cs.index(b"\xff\x52")
    return {
        "bpcc": (bpcc, "bpcc"),
        "a tile missing": (_joined(tiled, [(s, m, d) for s, m, d in last[:-1]]), "missing"),
        "17 bits": (cs[:42] + bytes([16]) + cs[43:], "17-bit"),
        "HTJ2K code-blocks": (cs[:k + 12] + b"\x40" + cs[k + 13:], "HTJ2K"),
        "Part-2 marker": (_in_main_header(cs, _segment(0xFF74, b"\x00\x00")), "Part-2"),
    }


@pytest.mark.parametrize("name", list(_still_refused()))
def test_what_is_left_is_refused_by_name(name):
    data, word = _still_refused()[name]
    with pytest.raises(ValueError, match=f"JPEG 2000.*{word}.*not decoded by the port"):
        codecs.decode(data)
