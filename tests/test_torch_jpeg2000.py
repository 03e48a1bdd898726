"""JPEG 2000 (data/jpeg2000.py, its tier 1 in csrc/jpeg2000_t1.cc) on the CPU:
streams PIL's encoder writes at test time over its save options, and JP2
headers and codestreams rewritten here for what it does not write (CMYK and
palette JP2, ICC and unknown colour boxes, several tile-parts a tile, COC,
QCC, TLM, PLM), decoded to PIL's `convert("RGB")` pixels exactly; the C++
tier 1 held to the plain version bit for bit on every code-block; the
serving and loading entry points held to the JAX package's on JP2 and raw
codestreams; each feature the port does not decode refused by name, and
bomb and truncated streams refused before a large allocation.

The tier-1 library is built with the host C++ compiler ($CXX or g++) at the
first decode, as the port builds it; the images are 24x16 to 64x48."""

import io
import struct
import tracemalloc

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.data.loader import decode_original as j_decode_original
from shmgan_tpu.data.loader import decode_resize as j_decode_resize
from shmgan_tpu.serve_http import _decode_request_image as j_decode_request_image
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data import jpeg2000 as j2k
from shmgan_tpu_torch.data.loader import decode_original, decode_resize
from shmgan_tpu_torch.data.synthetic import camera_image, synth_polar_scene
from shmgan_tpu_torch.runtime import build
from shmgan_tpu_torch.serve_http import _decode_request_image


def _scene(h, w, seed):
    views, diffuse, _ = synth_polar_scene(np.random.default_rng(seed), h, w)
    return (np.clip(camera_image(diffuse, views), 0, 1) * 255).astype(np.uint8)


def _photo(h, w, seed=0):
    """A smooth, noisy uint8 RGB image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0), 128 + 80 * np.cos(yy / 5.0),
                    (2 * xx + yy) % 256], -1) + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _image(kind, h=16, w=24, seed=0):
    rgb = _scene(h, w, seed)
    if kind == "RGB":
        return Image.fromarray(rgb)
    if kind == "L":
        return Image.fromarray(rgb[..., 1])
    if kind == "LA":
        return Image.fromarray(np.dstack([rgb[..., 1], rgb[..., 2]]), "LA")
    if kind == "RGBA":
        return Image.fromarray(np.dstack([rgb, _photo(h, w, seed)[..., 0]]), "RGBA")
    if kind == "photo":
        return Image.fromarray(_photo(h, w, seed))
    if kind.startswith("I;16"):                 # values past 255 and below it: PIL clips
        scale = 257 if kind == "I;16 full" else 3
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * scale).convert("I;16")
    raise ValueError(kind)


def _jp2(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


# -- PIL's save options ------------------------------------------------------------------

_CASES = {
    "5/3": ("RGB", {}),
    "9/7": ("RGB", dict(irreversible=True)),
    "5/3 mct": ("RGB", dict(mct=1)),
    "9/7 mct": ("RGB", dict(irreversible=True, mct=1)),
    "raw codestream": ("RGB", dict(no_jp2=True)),
    "raw codestream 9/7 mct": ("photo", dict(no_jp2=True, irreversible=True, mct=1)),
    "tiles with offsets": ("RGB", dict(tile_size=(8, 8), tile_offset=(3, 2), offset=(5, 4))),
    "odd tiles and offsets 9/7": ("photo", dict(tile_size=(15, 13), tile_offset=(1, 1),
                                                offset=(1, 1), irreversible=True), 48, 64),
    "image offset 20x14 tiles": ("RGB", dict(tile_size=(20, 14), tile_offset=(2, 1),
                                             offset=(7, 3)), 48, 64),
    "1 resolution": ("RGB", dict(num_resolutions=1)),
    "2 resolutions 9/7": ("RGB", dict(num_resolutions=2, irreversible=True)),
    "3 resolutions": ("RGB", dict(num_resolutions=3)),
    "4 resolutions 9/7": ("photo", dict(num_resolutions=4, irreversible=True), 48, 64),
    "5 resolutions": ("photo", dict(num_resolutions=5), 48, 64),
    "6 resolutions 9/7": ("photo", dict(num_resolutions=6, irreversible=True, mct=1), 48, 64),
    "code-blocks 4x4": ("RGB", dict(codeblock_size=(4, 4))),
    "code-blocks 4x64": ("photo", dict(codeblock_size=(4, 64)), 48, 64),
    "code-blocks 64x4 9/7": ("photo", dict(codeblock_size=(64, 4), irreversible=True), 48, 64),
    "code-blocks 16x8": ("RGB", dict(codeblock_size=(16, 8))),
    "precincts LRCP": ("photo", dict(precinct_size=(16, 16), progression="LRCP",
                                     num_resolutions=5), 48, 64),
    "precincts RLCP": ("photo", dict(precinct_size=(32, 32), progression="RLCP",
                                     quality_layers=[40, 10]), 48, 64),
    "precincts RPCL": ("photo", dict(precinct_size=(16, 16), progression="RPCL",
                                     num_resolutions=4), 48, 64),
    "precincts PCRL": ("photo", dict(precinct_size=(32, 32), progression="PCRL",
                                     irreversible=True), 48, 64),
    "precincts CPRL": ("photo", dict(precinct_size=(8, 8), progression="CPRL",
                                     num_resolutions=4), 48, 64),
    "CPRL tiles precincts layers": ("RGB", dict(progression="CPRL", precinct_size=(16, 16),
                                                tile_size=(16, 8), quality_layers=[30, 12, 4])),
    "RPCL 9/7 tiles offset": ("photo", dict(progression="RPCL", precinct_size=(32, 32),
                                            tile_size=(24, 20), tile_offset=(2, 3), offset=(5, 6),
                                            irreversible=True, mct=1), 48, 64),
    "1 layer by rate 9/7": ("RGB", dict(irreversible=True, quality_layers=[20])),
    "3 layers by rates 9/7": ("photo", dict(irreversible=True, quality_layers=[60, 20, 6]),
                              48, 64),
    "2 layers by rates 5/3": ("RGB", dict(quality_layers=[30, 10])),
    "3 layers by dB 9/7": ("photo", dict(irreversible=True, quality_mode="dB",
                                         quality_layers=[26, 34, 42]), 48, 64),
    "2 layers by dB 5/3": ("RGB", dict(quality_mode="dB", quality_layers=[30, 45])),
    "PLT": ("RGB", dict(plt=True, tile_size=(12, 8))),
    "comment": ("RGB", dict(comment="a JPEG 2000 comment")),
    "signed": ("RGB", dict(signed=True)),
    "signed 9/7 mct": ("RGB", dict(signed=True, irreversible=True, mct=1)),
    "L": ("L", {}),
    "L raw 9/7": ("L", dict(no_jp2=True, irreversible=True)),
    "L signed": ("L", dict(signed=True)),
    "I;16": ("I;16", {}),
    "I;16 raw": ("I;16", dict(no_jp2=True)),
    "I;16 full range 9/7": ("I;16 full", dict(irreversible=True)),
    "I;16 signed raw": ("I;16 full", dict(signed=True, no_jp2=True)),
    "LA": ("LA", {}),
    "LA raw 9/7": ("LA", dict(no_jp2=True, irreversible=True)),
    "RGBA": ("RGBA", {}),
    "RGBA raw mct": ("RGBA", dict(no_jp2=True, mct=1)),
    "RGBA 9/7 layers": ("RGBA", dict(irreversible=True, quality_layers=[20, 5])),
}


def _case_bytes(name):
    kind, kw, *shape = _CASES[name]
    h, w = shape or (16, 24)
    return _jp2(_image(kind, h, w, seed=len(name)), **kw)


# -- JP2 headers and codestreams rewritten -----------------------------------------------

def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def _split_boxes(data, pos=0, end=None):
    end = len(data) if end is None else end
    out = []
    while pos < end:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        n = n or end - pos
        out.append((kind, data[pos + 8:pos + n]))
        pos += n
    return out


def _with_header(data, header, ftyp=None):
    """A JP2 file with its jp2h sub-boxes replaced by `header`
    [(kind, body)] (and its ftyp body by `ftyp`)."""
    boxes = _split_boxes(data)
    out = b""
    for kind, body in boxes:
        if kind == b"jp2h":
            body = b"".join(_box(k, b) for k, b in header)
        elif kind == b"ftyp" and ftyp is not None:
            body = ftyp
        out += _box(kind, body)
    return out


def _header(data):
    return _split_boxes(dict(_split_boxes(data))[b"jp2h"])


def _colr(enum):
    return b"colr", struct.pack(">BBBI", 1, 0, 0, enum)


def _codestream(data):
    return dict(_split_boxes(data))[b"jp2c"] if data[:4] != j2k.J2K_SIGNATURE else data


def _segment(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _set_siz(cs, offset, value, fmt=">H"):
    return cs[:6 + offset] + struct.pack(fmt, value) + cs[6 + offset + struct.calcsize(fmt):]


def _after_siz(cs, segments):
    """The codestream with `segments` put right after SIZ."""
    n = struct.unpack(">H", cs[4:6])[0]
    return cs[:4 + n] + segments + cs[4 + n:]


def _before_sot(cs, segments):
    """The codestream with `segments` put at the end of the main header."""
    i = cs.index(b"\xff\x90")
    return cs[:i] + segments + cs[i:]


def _tile_parts(cs):
    """[(position of SOT, tile, Psot)] of a codestream."""
    out, pos = [], cs.index(b"\xff\x90")
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", cs[pos + 4:pos + 10])
        out.append((pos, isot, psot))
        pos += psot
    return out


def _split_tile_parts(cs):
    """Every tile in two tile-parts: its data cut in the middle, a second SOT
    (TPsot 1, TNsot 2) before the second half."""
    parts = _tile_parts(cs)
    out = cs[:parts[0][0]]
    for pos, isot, psot in parts:
        part = cs[pos:pos + psot]
        sod = part.index(b"\xff\x93") + 2
        cut = sod + (psot - sod) // 2
        head, tail = part[:cut], part[cut:]
        out += (head[:4] + struct.pack(">HIBB", isot, len(head), 0, 2) + head[12:]
                + struct.pack(">HHHIBB", 0xFF90, 10, isot, 12 + 2 + len(tail), 1, 2)
                + b"\xff\x93" + tail)
    return out + b"\xff\xd9"


def _qcd(cs):
    """The main header's QCD body."""
    i = cs.index(b"\xff\x5c")
    return cs[i + 4:i + 2 + struct.unpack(">H", cs[i + 2:i + 4])[0]]


def _cod(cs):
    i = cs.index(b"\xff\x52")
    return cs[i + 4:i + 2 + struct.unpack(">H", cs[i + 2:i + 4])[0]]


def _in_first_tile_part(cs, segments):
    """`segments` put in the first tile-part's header, its Psot grown."""
    pos, isot, psot = _tile_parts(cs)[0]
    return (cs[:pos + 4] + struct.pack(">HI", isot, psot + len(segments)) + cs[pos + 10:pos + 12]
            + segments + cs[pos + 12:])


def _rewritten():
    rgb = _jp2(_image("RGB", seed=3))
    rgba = _jp2(_image("RGBA", seed=4))
    grey = _jp2(_image("L", seed=5))
    la = _jp2(_image("LA", seed=6))
    ihdr = dict(_header(grey))[b"ihdr"]
    entries = [(10, 20, 30), (40, 50, 60), (10, 20, 30)] + [
        tuple(int(v) for v in (7 * i % 256, 13 * i % 256, 29 * i % 256)) for i in range(3, 250)]
    pclr = struct.pack(">HB", len(entries), 3) + bytes([7, 7, 7]) + b"".join(map(bytes, entries))
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3))
    pclr4 = (struct.pack(">HB", 200, 4) + bytes([7] * 4)
             + b"".join(bytes((i, 255 - i, i // 2, i % 7)) for i in range(200)))
    cmap4 = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(4))
    cs = _codestream(rgb)
    qcd = _qcd(cs)
    cod = _cod(cs)
    n_comps = 3
    guard_more = bytes([qcd[0] + 0x20]) + qcd[1:]          # one more guard bit
    return {
        "CMYK": _with_header(rgba, [(b"ihdr", dict(_header(rgba))[b"ihdr"]), _colr(12)]),
        "P with repeated entries": _with_header(grey, [(b"ihdr", ihdr), _colr(16),
                                                       (b"pclr", pclr), (b"cmap", cmap)]),
        "PA": _with_header(la, [(b"ihdr", dict(_header(la))[b"ihdr"]), _colr(16),
                                (b"pclr", pclr4), (b"cmap", cmap4)]),
        "cdef swapping channels": _with_header(rgb, _header(rgb) + [
            (b"cdef", struct.pack(">H", 3) + b"".join(struct.pack(">HHH", i, 0, 3 - i)
                                                       for i in range(3)))]),
        "ICC colr": _with_header(rgb, [(b"ihdr", dict(_header(rgb))[b"ihdr"]),
                                       (b"colr", b"\x02\x00\x00" + bytes(range(128)))]),
        "unknown colr enumeration": _with_header(rgb, [(b"ihdr", dict(_header(rgb))[b"ihdr"]),
                                                       _colr(99)]),
        "no colr": _with_header(grey, [(b"ihdr", ihdr)]),
        "res box": _with_header(rgb, _header(rgb) + [
            (b"res ", _box(b"resc", struct.pack(">HHHHBB", 3, 1, 3, 1, 2, 2)))]),
        "jpx brand": _with_header(rgb, _header(rgb), ftyp=b"jpx \x00\x00\x00\x00jpx jp2 "),
        "two tile-parts a tile": _split_tile_parts(_codestream(_jp2(
            _image("RGB", seed=7), tile_size=(12, 8), irreversible=True))),
        "COC like COD": _after_siz(cs, _segment(0xFF53, b"\x01" + bytes([cod[0] & 1])
                                                + cod[5:])),
        "QCC with a guard bit more": _before_sot(cs, _segment(0xFF5D, b"\x02" + guard_more)),
        # openjpeg reads the markers in order: the QCD after this QCC overrides it
        "QCC before QCD": _after_siz(cs, _segment(0xFF5D, b"\x02" + guard_more)),
        "COC then QCC": _before_sot(cs, _segment(0xFF53, b"\x00" + bytes([cod[0] & 1])
                                                 + cod[5:]) + _segment(0xFF5D, b"\x00"
                                                                       + guard_more)),
        "QCC in a tile-part header": _in_first_tile_part(cs, _segment(0xFF5D, b"\x01"
                                                                      + guard_more)),
        "QCD in a tile-part header": _in_first_tile_part(cs, _segment(0xFF5C, guard_more)),
        "TLM and PLM": _after_siz(cs, _segment(0xFF55, b"\x00\x50" + b"\x00" * 3 * n_comps)
                                  + _segment(0xFF57, b"\x00\x01\x02\x03")),
        # openjpeg skips the colour transform below three components
        "MCT flag on two components": _set_mct(_codestream(_jp2(_image("LA", seed=9)))),
        # openjpeg decodes a Part-1 stream whatever its Rsiz capability bits say
        "Rsiz bit 14 (HTJ2K) on a Part-1 stream": _set_siz(cs, 0, 0x4000),
        "Rsiz bit 15 (Part 2) on a Part-1 stream": _set_siz(cs, 0, 0x8000),
        "scalar derived 9/7": _derived(_codestream(_jp2(_image("photo", 48, 64, seed=8),
                                                         irreversible=True))),
        # decoded since the port took these features; a code-block style or
        # SOP flagged on a stream written without it, as PIL decodes it
        **{f"{name} flagged": _set_cod_style(cs, bit) for bit, name in (
            (0x02, "RESET"), (0x08, "VSC"), (0x10, "PTERM"), (0x20, "SEGSYM"))},
        "SOP flagged": _set_scod(cs, 0x02),
        "sub-sampled": _set_siz(cs, 36 + 3 * 1 + 1, 2, ">B"),
        "RGN": _after_siz(cs, _segment(0xFF5E, b"\x00\x00\x03")),
        "CRG": _after_siz(cs, _segment(0xFF63, b"\x00\x00\x00\x00" * 3)),
        "sYCC": _with_header(rgb, [(b"ihdr", dict(_header(rgb))[b"ihdr"]), _colr(18)]),
    }


def _set_cod_style(cs, style):
    i = cs.index(b"\xff\x52")
    return cs[:i + 4 + 8] + bytes([style]) + cs[i + 4 + 9:]


def _set_scod(cs, scod):
    i = cs.index(b"\xff\x52")
    return cs[:i + 4] + bytes([scod]) + cs[i + 5:]


def _set_mct(cs):
    i = cs.index(b"\xff\x52")
    return cs[:i + 8] + b"\x01" + cs[i + 9:]


def _derived(cs):
    """A 9/7 codestream with its QCD turned to scalar derived (the LL step
    alone; PIL's encoder writes expounded steps)."""
    i = cs.index(b"\xff\x5c")
    n = struct.unpack(">H", cs[i + 2:i + 4])[0]
    body = cs[i + 4:i + 2 + n]
    new = bytes([(body[0] & 0xE0) | 1]) + body[1:3]
    return cs[:i] + _segment(0xFF5C, new) + cs[i + 2 + n:]


@pytest.fixture(scope="module")
def streams():
    out = {name: _case_bytes(name) for name in _CASES}
    out.update(_rewritten())
    return out


_ALL = list(_CASES) + list(_rewritten())


@pytest.mark.parametrize("name", _ALL)
def test_decodes_to_pils_pixels(streams, name):
    data = streams[name]
    want = _pil_rgb(data)
    np.testing.assert_array_equal(codecs.decode(data), want)


@pytest.mark.parametrize("name", _ALL)
def test_cpp_tier1_equals_the_plain_version_on_every_code_block(streams, name):
    blocks = j2k.tier1_inputs(streams[name])
    assert blocks
    native, plain = j2k.tier1(blocks), j2k.tier1(blocks, plain=True)
    for b, got, want in zip(blocks, native, plain):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"{b.comp} {b.res} {b.x0} {b.y0}")


def test_the_palette_follows_pils_deduplication(streams):
    """Index 2 repeats entry 0: PIL's palette drops it, so indices past it
    take the next entry's colour, and the last index is black."""
    rgb = _pil_rgb(streams["P with repeated entries"])
    np.testing.assert_array_equal(codecs.decode(streams["P with repeated entries"]), rgb)
    with Image.open(io.BytesIO(streams["P with repeated entries"])) as im:
        assert im.mode == "P"
    assert len(j2k._read_jp2(streams["P with repeated entries"])[0].palette) == 249


def test_cases_cover_every_progression_and_both_transforms(streams):
    progs, transforms, modes = set(), set(), set()
    for name in _ALL:
        cs = _codestream(streams[name])
        st = j2k._parse(cs)
        for t in st.tiles.values():
            progs.add(t.prog)
            transforms.update(c.reversible for c in t.coding)
        with Image.open(io.BytesIO(streams[name])) as im:
            modes.add(im.mode)
    assert progs == {0, 1, 2, 3, 4} and transforms == {True, False}
    assert modes == {"L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P", "PA"}


# -- against the JAX package's entry points ----------------------------------------------

_BODIES = {"jp2": dict(), "jp2 9/7": dict(irreversible=True, quality_layers=[20, 8]),
           "j2k": dict(no_jp2=True, mct=1)}


@pytest.mark.parametrize("kind", list(_BODIES))
@pytest.mark.parametrize("size", [256, "native"])
def test_request_decode_equals_jaxs(kind, size):
    body = _jp2(Image.fromarray(_photo(45, 61, seed=11)), **_BODIES[kind])
    np.testing.assert_array_equal(_decode_request_image(body, size),
                                  j_decode_request_image(body, size))


@pytest.mark.parametrize("kind", list(_BODIES))
@pytest.mark.parametrize("image_size", [48, 128])
def test_decode_resize_and_original_equal_jax(tmp_path, kind, image_size):
    path = str(tmp_path / "img.png")     # a file is decoded by its bytes, never its name
    with open(path, "wb") as f:
        f.write(_jp2(Image.fromarray(_photo(45, 61, seed=12)), **_BODIES[kind]))
    got, want = decode_resize(path, image_size), j_decode_resize(path, image_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


# -- the C++ tier 1: built at first use, no fallback -------------------------------------

def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "jpeg2000_t1.cc").write_text("int f( {\n")
    monkeypatch.setattr(build, "CSRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(j2k, "_lib", None)

    def plain(*a, **k):
        raise AssertionError("the plain tier 1 was reached")

    monkeypatch.setattr(j2k, "t1_block_plain", plain)
    with pytest.raises(RuntimeError, match=r"jpeg2000_t1\.cc.*error"):
        codecs.decode(_jp2(_image("RGB")))


def test_decode_runs_the_library_and_never_the_plain_version(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain tier 1 was reached")

    monkeypatch.setattr(j2k, "t1_block_plain", plain)
    before = j2k.calls
    data = _jp2(_image("RGB", seed=9), irreversible=True)
    np.testing.assert_array_equal(codecs.decode(data), _pil_rgb(data))
    assert j2k.calls == before + 1


def test_the_library_refuses_a_code_block_out_of_range():
    blk = j2k.tier1_inputs(_jp2(_image("RGB")))[0]
    blk.numbps = 31
    with pytest.raises(ValueError, match="code-block 0"):
        j2k.tier1([blk])


# -- refusals by name ----------------------------------------------------------------------

def _refusals():
    cs = _codestream(_jp2(_image("RGB", seed=13)))
    rgb = _jp2(_image("RGB", seed=13))
    grey = _jp2(_image("L", seed=14))
    ihdr = dict(_header(grey))[b"ihdr"]
    pclr16 = struct.pack(">HB", 2, 3) + bytes([15, 15, 15]) + bytes(12)
    out = {"HTJ2K": (_set_cod_style(cs, 0x40), "HTJ2K")}
    out.update({
        "17 bits": (_set_siz(cs, 36, 16, ">B"), "17-bit"),
        "POC": (_after_siz(cs, _segment(0xFF5F, b"\x00\x00\x00\x01\x02\x00")), "POC"),
        "PPM": (_after_siz(cs, _segment(0xFF60, b"\x00")), "PPM"),
        "PPT": (_in_first_tile_part(cs, _segment(0xFF61, b"\x00")), "PPT"),
        "EPH": (_set_scod(cs, 0x04), "EPH"),
        "HTJ2K CAP": (_after_siz(cs, _segment(0xFF50, b"\x00\x02\x00\x00\x00\x00")), "HTJ2K"),
        "HTJ2K CPF": (_after_siz(cs, _segment(0xFF59, b"\x00\x00")), "HTJ2K"),
        "Part-2 MCT marker": (_after_siz(cs, _segment(0xFF74, b"\x00\x00")), "Part-2"),
        "bpcc": (_with_header(rgb, _header(rgb) + [(b"bpcc", b"\x07\x07\x07")]), "bpcc"),
        "16-bit palette": (_with_header(grey, [(b"ihdr", ihdr), _colr(16),
                                               (b"pclr", pclr16)]), "pclr"),
        "MCT over 5/3 and 9/7": (_before_sot(_codestream(_jp2(_image("RGB", seed=16), mct=1)),
                                             _segment(0xFF53, b"\x01\x00\x04\x04\x04\x00\x00")),
                                 "reversible and irreversible"),
        "a tile missing": (_drop_last_tile(_codestream(_jp2(_image("RGB", seed=15),
                                                            tile_size=(12, 8)))), "missing"),
        "JPM brand": (_with_header(rgb, _header(rgb), ftyp=b"jpm \x00\x00\x00\x00jpm "),
                      "brand"),
    })
    return out


def _drop_last_tile(cs):
    pos = _tile_parts(cs)[-1][0]
    return cs[:pos] + b"\xff\xd9"


@pytest.mark.parametrize("name", list(_refusals()))
def test_what_the_port_does_not_decode_is_refused_by_name(name):
    data, word = _refusals()[name]
    with pytest.raises(ValueError, match=f"JPEG 2000.*{word}"):
        codecs.decode(data)


# -- bombs and truncation ----------------------------------------------------------------

def _bombs():
    cs = _codestream(_jp2(_image("RGB", seed=16)))
    return {
        # 40000 x 40000 pixels: more than PIL opens
        "pixels": (_set_siz(_set_siz(cs, 2, 40000, ">I"), 6, 40000, ">I"), "pixels"),
        # 13000 x 13000 in 1 x 1 tiles: 1.7e8 tiles from a few hundred bytes
        "tiles": (_set_siz(_set_siz(_set_siz(_set_siz(cs, 2, 13000, ">I"), 6, 13000, ">I"),
                                    18, 1, ">I"), 22, 1, ">I"), "tiles"),
        # 65535 layers of packets
        "packets": (_set_layers(cs, 65535), "packets"),
        # 13000 x 13000 in 4 x 4 code-blocks, one tile
        "code-blocks": (_set_cblk(_set_siz(_set_siz(_set_siz(_set_siz(
            cs, 2, 13000, ">I"), 6, 13000, ">I"), 18, 13000, ">I"), 22, 13000, ">I")),
            "code-blocks"),
    }


def _set_layers(cs, n):
    i = cs.index(b"\xff\x52")
    return cs[:i + 6] + struct.pack(">H", n) + cs[i + 8:]


def _set_cblk(cs):
    i = cs.index(b"\xff\x52")
    return cs[:i + 10] + b"\x00\x00" + cs[i + 12:]


@pytest.mark.parametrize("name", list(_bombs()))
def test_bombs_are_refused_before_a_large_allocation(name):
    data, word = _bombs()[name]
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=word):
            codecs.decode(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 8 << 20, peak


@pytest.mark.parametrize("kind", ["jp2", "j2k 9/7 layers"])
def test_truncated_streams_raise_value_error(kind):
    data = _jp2(_image("photo", 32, 40, seed=17),
                **({} if kind == "jp2" else dict(no_jp2=True, irreversible=True,
                                                   quality_layers=[20, 5])))
    for cut in sorted({1, 8, 20, 40, 60, 90, 130, len(data) // 3, len(data) // 2,
                       len(data) - 40, len(data) - 3, len(data) - 1}):
        with pytest.raises(ValueError):
            codecs.decode(data[:cut])


def test_corrupt_code_block_bytes_decode_or_raise_value_error():
    """Flipped bytes in the packet data: tier 1 reads any bytes; a header
    that goes wrong raises ValueError, never another exception."""
    data = bytearray(_jp2(_image("photo", 32, 40, seed=18), no_jp2=True))
    rng = np.random.default_rng(19)
    sod = data.index(b"\xff\x93") + 2
    for _ in range(12):
        bad = bytearray(data)
        for i in rng.integers(sod, len(data) - 2, 6):
            bad[i] = int(rng.integers(0, 256))
        try:
            out = codecs.decode(bytes(bad))
            assert out.shape == (32, 40, 3)
        except ValueError:
            pass
