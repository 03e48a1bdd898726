"""JPEG 2000 (ISO/IEC 15444-1, ITU-T T.800) decoding in numpy and the standard
library, with tier 1 in host C++: what the JAX package gets from PIL's
`Image.open(...).convert("RGB")` (Jpeg2KImagePlugin and Pillow's
Jpeg2KDecode.c, which decode through openjpeg 2.5 a tile at a time), pixel
for pixel.

    rgb = decode_jpeg2000(data)                  # (H, W, 3) uint8
    blocks = tier1_inputs(data)                  # every code-block's tier-1 input
    coefs = tier1(blocks)                        # csrc/jpeg2000_t1.cc
    coefs = tier1(blocks, plain=True)            # the plain version (tests only)

Containers: a JP2 file (the signature box, `ftyp` of brand `jp2 ` or `jpx `,
`jp2h` with `ihdr`, `colr` (enumerated or ICC), `pclr` + `cmap`, `cdef` and
`res `, then `jp2c`; PIL decodes a tile at a time, where openjpeg applies
neither the palette nor the channel definitions) or a raw codestream
(`FF4F FF51`). The mode is chosen by PIL's rules, which decide its
`convert("RGB")`: from `ihdr` (JP2) or SIZ (raw), one component of more
than 8 bits (JP2: 9, raw: 8) is I;16, which clips at 255; two are LA and
four RGBA, whose alpha is dropped; `colr` 12 on four components is CMYK
(PIL's cmyk2rgb); a `pclr` of 8-bit entries on L or LA is P or PA, its
entries deduplicated in order as PIL's ImagePalette.getcolor collects them,
an index past them black. Pillow's unpacker then scales each component to
the mode's bits (shifted, rounding half up when it narrows; signed samples
offset by half their range). `colr` 18 (sYCC) goes through Pillow's
ImagingConvertYCbCr2RGB; so does a colour space openjpeg leaves
unspecified (a raw codestream) or unknown (no `colr`, an ICC profile, an
enumeration it does not know) where the first component is at full size
and the second or third sub-sampled: Pillow's rule, not openjpeg's, whose
opj_read_header reports them unspecified or unknown. Sub-sampled components
are read as Pillow's RGB and YCbCr unpackers read them: component n at byte
sum(size * (w / dx) * (h / dy)) of those before it in openjpeg's tile
buffer, pixel (x, y) at (y / dy) * (w / dx) + x / dx of it, in C's integer
division, the buffer zeroed past openjpeg's samples for each tile.

Codestream: SIZ (image and tile offsets, 1-4 components, 1-16 bits, signed
or not, sub-sampled by any XRsiz and YRsiz from 1 to 255), COD and COC,
QCD and QCC (no quantisation, scalar derived, scalar expounded), RGN
(max-shift, Srgn not read, as openjpeg), POC (in the main header and any
tile-part's, a tile's appended to the main header's as openjpeg appends
them), PPM and PPT (packet headers merged in Zppm/Zppt order, Nppm
dropped, as openjpeg merges them; PPM read across the tiles in the order
openjpeg completes them), CRG (read and ignored), COM, TLM, PLM and PLT
(skipped), SOT with several tile-parts a tile in any order, SOD, EOC. Tier
2: tag trees, packet headers, SOP markers (skipped where present, passed
over where not, as openjpeg) and EPH markers (openjpeg fails without one),
empty packets, code-block inclusion, zero bit-planes, pass counts, each
codeword segment's length (Lblock + floor(log2(its passes)) bits; a
segment holds 1 pass under TERMALL, 10 then 2 and 1 in turn under BYPASS,
else 109, as openjpeg's opj_t2_init_seg), precinct partitions at every
resolution (Scod bit 0), and the five progressions iterated as openjpeg's
pi.c iterates them (POC entries one after another, each packet at its
first visit; a component sub-sampled by dx steps by dx << (ppx + level)).
Tier 1, as openjpeg's opj_t1_decode_cblk: the MQ decoder (T.800 Table C.2)
and the significance, refinement and cleanup passes with run-length mode
and the context tables of Tables D.1, D.3 and D.4, each codeword segment
read from its own bytes; BYPASS's raw significance and refinement passes
below the 4th bit-plane, RESET's context reset after each MQ pass, VSC's
vertically causal contexts, SEGSYM's four UNIFORM decisions after each
cleanup (not checked, as openjpeg), PTERM (nothing to do); magnitudes held
at twice their scale with the mid-point of the last decoded bit-plane, as
openjpeg holds them, RGN's shift above them undone after. Then, as
openjpeg's tcd.c: reversible coefficients halved toward zero, irreversible
ones times half the sub-band's float32 step size (its gain left out,
openjpeg's BUG_WEIRD_TWO_INVK); the inverse 5/3 in integers and the inverse
9/7 in float32 with openjpeg's constants (K, 1.625732422 for the high band)
and order (rows, then columns; each lifting step (left + right) * c added),
whole-sample symmetric extension, at any size and offset; the inverse RCT
or ICT when the MCT flag is set; the DC level shift after lrintf's round
half to even, then the clamp to the component's range.

Tier 1 is the costly part (a decision of the MQ coder at a time): `tier1`
runs it in csrc/jpeg2000_t1.cc, built by runtime/build.py at the first
JPEG 2000 decode and loaded through ctypes; a failed build raises. The
plain Python version is reached only through `tier1(blocks, plain=True)`
(the tests hold the C++ to it, bit for bit, on every code-block).

Refused with a ValueError that names the feature the port does not decode:
HTJ2K (CAP, CPF, HT code-blocks), Part-2 extensions (their markers, wavelet
kernels, component transforms and JPX boxes), more than 16 bits, `bpcc`, a
`pclr` of other than 8-bit entries, the colour transform over reversible
and irreversible components, a tile missing from the stream.

Refused with a ValueError that says PIL refuses it too: what openjpeg or
Pillow fails on (e-sYCC and the other colour spaces and layouts Pillow's
unpackers have no case for, sub-sampled grey, a missing EPH, the colour
transform over components of other sizes, a corrupt or misplaced marker).
A header that claims more pixels than PIL opens, more tiles, packets or
code-blocks than the stream can hold, or bytes past its end raises before
any of it is allocated, as does input cut short or corrupt.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# code-block styles (COD/COC's SPcod): what tier 2 and tier 1 do for each
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 0x01, 0x02, 0x04, 0x08, 0x10, 0x20
_REFUSED_MARKERS = {0xFF50: "HTJ2K (CAP, Part 15)", 0xFF59: "HTJ2K (CPF, Part 15)"}
# markers openjpeg takes only in the main header, or only in a tile-part's
_MAIN_ONLY = {0xFF60: "PPM", 0xFF63: "CRG"}
_TILE_ONLY = {0xFF61: "PPT"}
_PART2_MARKERS = range(0xFF70, 0xFF80)   # MCT, MCC, MCO, CBD, NLT, ... (T.801)
_SKIPPED_MARKERS = (0xFF64, 0xFF55, 0xFF57, 0xFF58)   # COM, TLM, PLM, PLT

# openjpeg's colour spaces, as opj_jp2_read_header sets them from `colr`
# (an ICC profile, an enumeration it does not know, or no `colr`: unspecified)
_CS_UNSPECIFIED, _CS_SRGB, _CS_GRAY, _CS_SYCC, _CS_EYCC, _CS_CMYK = range(6)
_ENUMCS = {16: _CS_SRGB, 17: _CS_GRAY, 18: _CS_SYCC, 24: _CS_EYCC, 12: _CS_CMYK}
_CS_NAMES = ("unspecified", "sRGB", "grey", "sYCC", "e-sYCC", "CMYK")
# Pillow's j2k_unpackers that a mode of PIL's rules can meet (the mode's
# components are SIZ's): (mode, colour space, components) -> how it unpacks
_UNPACKERS = {
    ("L", _CS_GRAY, 1): "grey", ("P", _CS_SRGB, 1): "grey", ("PA", _CS_SRGB, 2): "grey",
    ("I;16", _CS_GRAY, 1): "grey16", ("LA", _CS_GRAY, 2): "grey",
    ("RGB", _CS_SRGB, 3): "rgb", ("RGBA", _CS_SRGB, 4): "rgb", ("CMYK", _CS_CMYK, 4): "rgb",
    ("RGB", _CS_SYCC, 3): "sycc", ("RGBA", _CS_SYCC, 4): "sycc",
}

# the inverse 9/7 of openjpeg's dwt.c, in float32
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFT97 = (np.float32(-0.443506852), np.float32(-0.882911075), np.float32(0.052980118),
           np.float32(1.586134342))      # -delta, -gamma, -beta, -alpha (T.800 F.3.8.2)


def _fail(what: str) -> ValueError:
    return ValueError(f"JPEG 2000: {what}")


def _refuse(feature: str) -> ValueError:
    return ValueError(f"JPEG 2000: {feature} is not decoded by the port")


# -- JP2 container --------------------------------------------------------------------

def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of each box in data[pos:end]."""
    while pos < end:
        if pos + 8 > end:
            raise _fail("truncated box header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise _fail("truncated box header")
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise _fail(f"box {kind!r} runs past the end of its container")
        yield kind, pos + head, pos + length
        pos += length


class _Jp2Header:
    """What PIL's _parse_jp2_header and openjpeg's JP2 reader take from `jp2h`."""

    def __init__(self):
        self.size = None           # (width, height) of ihdr
        self.nc = 0
        self.mode = None
        self.colour = _CS_UNSPECIFIED
        self.palette = None        # PIL's deduplicated entries, (n, 3) uint8


def _read_jp2(data: bytes) -> Tuple[_Jp2Header, bytes]:
    boxes = list(_boxes(data, 0, len(data)))
    if len(boxes) < 2 or boxes[1][0] != b"ftyp":
        raise _fail("no ftyp box after the signature")
    _, s, e = boxes[1]
    brands = [data[i:i + 4] for i in range(s + 8, e - 3, 4)] + [data[s:s + 4]]
    if data[s:s + 4] not in (b"jp2 ", b"jpx ") and b"jp2 " not in brands:
        raise _refuse(f"the brand {data[s:s + 4]!r} (not JP2 or JPX)")
    header, stream = None, None
    for kind, s, e in boxes[2:]:
        if kind == b"jp2h":
            if header is None:
                header = _read_jp2h(data, s, e)
        elif kind == b"jp2c":
            if header is None:
                raise _fail("jp2c box before the jp2h box")
            stream = data[s:e]
            break
        elif kind in (b"ftbl", b"asoc", b"jpch", b"jplh", b"cgrp", b"dtbl", b"rreq"):
            raise _refuse(f"JPX's Part-2 box {kind.decode('latin-1')!r}")
    if header is None:
        raise _fail("no jp2h box")
    if stream is None:
        raise _fail("no jp2c box (codestream)")
    return header, stream


def _read_jp2h(data: bytes, start: int, end: int) -> _Jp2Header:
    h = _Jp2Header()
    have_colr, have_pclr = False, False
    for kind, s, e in _boxes(data, start, end):
        body = data[s:e]
        if kind == b"ihdr":
            if len(body) < 14:
                raise _fail("truncated ihdr box")
            height, width, nc, bpc = struct.unpack(">IIHB", body[:11])
            if bpc == 255:
                raise _refuse("per-component bit depths (bpcc box)")
            h.size, h.nc = (width, height), nc
            # PIL's rules; I;16 from one component of more than 9 bits (bpc holds bits - 1)
            h.mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB",
                      4: "RGBA"}.get(nc)
            if h.mode is None:
                raise _fail(f"{nc} components: PIL refuses it too (no mode)")
        elif kind == b"colr":
            if len(body) < 3:
                raise _fail("truncated colr box")
            meth = body[0]
            enum = struct.unpack(">I", body[3:7])[0] if meth == 1 and len(body) >= 7 else None
            if not have_colr:          # openjpeg takes the first colr box
                have_colr = True
                if enum is not None:
                    h.colour = _ENUMCS.get(enum, _CS_UNSPECIFIED)
            if h.nc == 4 and enum == 12:         # PIL: any colr of enumeration 12
                h.mode = "CMYK"
        elif kind == b"pclr":
            if len(body) < 3:
                raise _fail("truncated pclr box")
            ne, npc = struct.unpack(">HB", body[:3])
            depths = body[3:3 + npc]
            if have_pclr or len(depths) < npc or not 1 <= npc <= 4 or ne == 0:
                raise _fail("corrupt pclr box")
            have_pclr = True
            if h.mode in ("L", "LA"):
                if any(d != 7 for d in depths):
                    raise _refuse("a palette (pclr) of other than 8-bit unsigned entries")
                if len(body) < 3 + npc + ne * npc:
                    raise _fail("truncated pclr box")
                entries = np.frombuffer(body, np.uint8, ne * npc, 3 + npc).reshape(ne, npc)
                seen: Dict[tuple, None] = {}
                for row in map(tuple, entries.tolist()):   # ImagePalette.getcolor
                    seen.setdefault(row, None)
                h.palette = np.array(list(seen), np.uint8).reshape(-1, npc)[:, :3]
                h.mode = "P" if h.mode == "L" else "PA"
        elif kind == b"cmap":
            if not have_pclr:
                raise _fail("cmap box without a pclr box")
        elif kind == b"res ":
            pass
        elif kind == b"bpcc":
            raise _refuse("per-component bit depths (bpcc box)")
        elif kind == b"cdef":       # decoded a tile at a time, openjpeg applies no cdef
            if len(body) < 2 or len(body) != 2 + 6 * _u16(body, 0):
                raise _fail("corrupt cdef box")
        else:
            raise _refuse(f"the jp2h box {kind.decode('latin-1')!r}")
    if h.size is None or h.mode is None:
        raise _fail("jp2h box without ihdr (PIL refuses it too)")
    return h


# -- codestream headers ---------------------------------------------------------------

class _Comp:
    __slots__ = ("prec", "sgnd", "dx", "dy")

    def __init__(self, prec, sgnd, dx=1, dy=1):
        self.prec, self.sgnd, self.dx, self.dy = prec, sgnd, dx, dy


class _Coding:
    """One component's coding and quantisation parameters (COD/COC, QCD/QCC)
    and its region-of-interest shift (RGN)."""
    __slots__ = ("nl", "cbw", "cbh", "reversible", "pp", "qstyle", "guard", "steps", "style",
                 "roishift")

    def __init__(self):
        self.roishift = 0

    def copy(self):
        c = _Coding()
        for k in self.__slots__:
            setattr(c, k, getattr(self, k))
        return c

    def step(self, r: int, band: int) -> Tuple[int, int]:
        """(exponent, mantissa) of sub-band `band` (0 LL, 1 HL, 2 LH, 3 HH) at
        resolution r, as openjpeg derives it."""
        if self.qstyle == 1:                       # scalar derived from the LL step
            e0, m0 = self.steps[0]
            return (max(0, e0 - (r - 1)) if r else e0), m0
        i = 0 if r == 0 else 3 * (r - 1) + band
        if i >= len(self.steps):
            raise _fail("QCD/QCC has fewer step sizes than sub-bands")
        return self.steps[i]


class _Tile:
    __slots__ = ("scod", "prog", "layers", "mct", "coding", "parts", "seen_parts", "pocs", "ppt")

    def __init__(self, scod, prog, layers, mct, coding, pocs):
        self.scod, self.prog, self.layers, self.mct = scod, prog, layers, mct
        self.coding = coding
        self.parts: List[Tuple[int, bytes]] = []
        self.seen_parts = 0
        self.pocs = list(pocs)     # openjpeg appends a tile-part's POC to the main header's
        self.ppt: Dict[int, bytes] = {}


class _Stream:
    """The parsed main header and each tile's tile-parts."""

    def __init__(self):
        self.comps: List[_Comp] = []
        self.tiles: Dict[int, _Tile] = {}
        self.order: List[int] = []     # the tiles in the order openjpeg completes them
        self.size = self.tiling = (0, 0, 0, 0)     # SIZ's (Xsiz, Ysiz, XOsiz, YOsiz), tiles'
        self.ntx = self.nty = 0
        self.ppm: Optional[bytes] = None           # PPM's packet headers, merged


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


def _read_siz(st: _Stream, body: bytes) -> None:
    if len(body) < 36:
        raise _fail("truncated SIZ")
    # Rsiz is not read: openjpeg decodes a Part-1 stream whatever its
    # capability bits say (HTJ2K and Part 2 are refused by what they use)
    xs, ys, xo, yo, xt, yt, xto, yto, nc = struct.unpack(">IIIIIIIIH", body[2:36])
    if len(body) != 36 + 3 * nc or not 1 <= nc:
        raise _fail("corrupt SIZ")
    if xo >= xs or yo >= ys or xt == 0 or yt == 0 or xto > xo or yto > yo \
            or xto + xt <= xo or yto + yt <= yo:
        raise _fail("SIZ: an empty image or tiles that miss it")
    check_size("JPEG 2000", xs - xo, ys - yo)
    if nc > 4:
        raise _fail(f"{nc} components: PIL refuses it too")
    for i in range(nc):
        ssiz, dx, dy = body[36 + 3 * i:39 + 3 * i]
        prec = (ssiz & 0x7F) + 1
        if dx == 0 or dy == 0:
            raise _fail(f"component {i}: XRsiz {dx}, YRsiz {dy}: openjpeg refuses 0 (PIL too)")
        if prec > 16:
            raise _refuse(f"{prec}-bit samples")
        st.comps.append(_Comp(prec, bool(ssiz & 0x80), dx, dy))
    st.size = (xs, ys, xo, yo)
    st.tiling = (xt, yt, xto, yto)
    st.ntx = -(-(xs - xto) // xt)
    st.nty = -(-(ys - yto) // yt)


def _read_spcod(body: bytes, pos: int, with_pp: bool, c: _Coding) -> None:
    if len(body) < pos + 5:
        raise _fail("truncated COD/COC")
    nl, xcb, ycb, style, transform = body[pos:pos + 5]
    if nl > 32:
        raise _fail(f"{nl} decomposition levels")
    if xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise _fail(f"code-block size 2^{xcb + 2} x 2^{ycb + 2}")
    if style & 0x80:
        raise _fail("code-block style 0x80 (mixed HT code-blocks): openjpeg refuses it too")
    if style & 0x40:
        raise _refuse("code-block style HTJ2K (HT code-blocks, Part 15)")
    if transform > 1:
        raise _refuse(f"wavelet transform {transform} (Part-2 kernels)")
    c.nl, c.cbw, c.cbh, c.reversible, c.style = nl, xcb + 2, ycb + 2, transform == 1, style
    if with_pp:
        pp = body[pos + 5:pos + 6 + nl]
        if len(pp) != nl + 1:
            raise _fail("truncated precinct sizes")
        c.pp = [(b & 15, b >> 4) for b in pp]
        if any((x == 0 or y == 0) and r > 0 for r, (x, y) in enumerate(c.pp)):
            raise _fail("a 1x1 precinct above resolution 0: openjpeg refuses it too")
    else:
        c.pp = [(15, 15)] * (nl + 1)


def _read_qcx(body: bytes, pos: int, c: _Coding) -> None:
    if len(body) <= pos:
        raise _fail("truncated QCD/QCC")
    sq = body[pos]
    c.qstyle, c.guard = sq & 0x1F, sq >> 5
    rest = body[pos + 1:]
    if c.qstyle == 0:
        c.steps = [(b >> 3, 0) for b in rest]
    elif c.qstyle in (1, 2):
        if len(rest) % 2 or not rest:
            raise _fail("corrupt QCD/QCC")
        words = [_u16(rest, i) for i in range(0, len(rest), 2)]
        c.steps = [(w >> 11, w & 0x7FF) for w in words]
        if c.qstyle == 1:
            c.steps = c.steps[:1]
    else:
        raise _fail(f"quantisation style {c.qstyle}")


def _comp_index(st: _Stream, body: bytes) -> int:
    """Ccoc/Cqcc/Crgn, one byte: SIZ allows at most 4 components."""
    if not body:
        raise _fail("truncated COC/QCC/RGN")
    i = body[0]
    if i >= len(st.comps):
        raise _fail(f"COC/QCC/RGN for component {i} of {len(st.comps)}")
    return i


def _segments(data: bytes, pos: int, stop_at_sot: bool):
    """(marker, body, position of the marker) until SOT or SOD."""
    while True:
        if pos + 2 > len(data):
            raise _fail("truncated header")
        m = _u16(data, pos)
        if m in (0xFF90, 0xFF93) or m == 0xFFD9:
            yield m, b"", pos
            return
        if m < 0xFF00:
            raise _fail(f"expected a marker at {pos}, found {m:#06x}")
        if pos + 4 > len(data):
            raise _fail("truncated marker segment")
        n = _u16(data, pos + 2)
        if n < 2 or pos + 2 + n > len(data):
            raise _fail(f"marker {m:#06x} runs past the end")
        yield m, data[pos + 4:pos + 2 + n], pos
        pos += 2 + n


def _coding_marker(st: _Stream, m: int, body: bytes, cod: list, coding: List[_Coding],
                   pocs: list) -> bool:
    """Apply COD, COC, QCD, QCC or RGN to `coding` (per component) and `cod`
    ([scod, progression, layers, mct]), or append a POC's entries to `pocs`;
    False for any other marker."""
    if m == 0xFF52:                     # COD: every component's coding
        if len(body) < 5:
            raise _fail("truncated COD")
        scod, prog, layers, mct = body[0], body[1], _u16(body, 2), body[4]
        if scod & ~0x07:                # precincts, SOP (0x02), EPH (0x04)
            raise _fail(f"COD style {scod:#x}")
        if prog > 4:
            raise _fail(f"progression order {prog}")
        if layers == 0:
            raise _fail("zero quality layers")
        if mct > 1:
            raise _refuse(f"multiple component transform {mct} (Part 2)")
        cod[:] = [scod, prog, layers, mct]
        for c in coding:
            _read_spcod(body, 5, bool(scod & 1), c)
    elif m == 0xFF53:                   # COC: one component's
        i = _comp_index(st, body)
        if len(body) < 2:
            raise _fail("truncated COC")
        if body[1] & ~1:
            raise _fail(f"COC style {body[1]:#x}")
        _read_spcod(body, 2, bool(body[1] & 1), coding[i])
    elif m == 0xFF5C:
        for c in coding:
            _read_qcx(body, 0, c)
    elif m == 0xFF5D:
        _read_qcx(body, 1, coding[_comp_index(st, body)])
    elif m == 0xFF5E:                   # RGN: Crgn, Srgn (not read, as openjpeg), SPrgn
        if len(body) != 3:
            raise _fail("corrupt RGN: openjpeg refuses it too")
        coding[_comp_index(st, body)].roishift = body[2]
    elif m == 0xFF5F:                   # POC: RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc
        if not body or len(body) % 7:
            raise _fail("corrupt POC: openjpeg refuses it too")
        if len(pocs) + len(body) // 7 >= 32:
            raise _fail("32 or more progression order changes: openjpeg refuses them too")
        for i in range(0, len(body), 7):
            rs, cs, lye, re, ce, prog = struct.unpack(">BBHBBB", body[i:i + 7])
            pocs.append((prog, rs, cs, lye, re, min(ce, len(st.comps))))
    else:
        return False
    return True


def _merge_ppm(markers: Dict[int, bytes]) -> bytes:
    """The packet headers of PPM segments in Zppm order, each Nppm length
    dropped (it may run from one segment into the next), as openjpeg's
    opj_j2k_merge_ppm reads them."""
    out, left = [], 0
    for z in sorted(markers):
        data = markers[z]
        take = min(left, len(data))
        out.append(data[:take])
        left -= take
        pos = take
        while pos < len(data):
            if len(data) - pos < 4:
                raise _fail("PPM: not enough bytes for Nppm: openjpeg refuses it too")
            (n,) = struct.unpack(">I", data[pos:pos + 4])
            out.append(data[pos + 4:pos + 4 + n])
            left = max(0, n - (len(data) - pos - 4))
            pos += 4 + n
    if left:
        raise _fail("PPM: packet headers cut short: openjpeg refuses them too")
    return b"".join(out)


def _packed_header(m: int, body: bytes, markers: Dict[int, bytes]) -> None:
    """A PPM or PPT segment's Zppm/Zppt and headers into `markers`."""
    name = "PPM" if m == 0xFF60 else "PPT"
    if len(body) < 2:
        raise _fail(f"corrupt {name}: openjpeg refuses it too")
    if body[0] in markers:
        raise _fail(f"{name} Z {body[0]} twice: openjpeg refuses it too")
    markers[body[0]] = body[1:]


def _parse(cs: bytes) -> _Stream:
    """The main header, then every tile-part's header and data."""
    if cs[:4] != J2K_SIGNATURE:
        raise _fail("no SOC/SIZ at the start of the codestream")
    st = _Stream()
    n = _u16(cs, 4) if len(cs) >= 6 else 0
    if n < 2 or 4 + n > len(cs):
        raise _fail("truncated SIZ")
    _read_siz(st, cs[6:4 + n])
    # COD/QCD set every component, COC/QCC one, each marker over the ones
    # before it, as openjpeg reads them (a QCD after a QCC overrides it)
    coding = [_Coding() for _ in st.comps]
    cod: list = []
    pocs: list = []
    ppm: Dict[int, bytes] = {}
    have_qcd = False
    pos = 4 + n
    for m, body, at in _segments(cs, pos, True):
        if m == 0xFF90:
            pos = at
            break
        if m in (0xFF93, 0xFFD9):
            raise _fail("SOD or EOC in the main header")
        if _coding_marker(st, m, body, cod, coding, pocs):
            have_qcd |= m == 0xFF5C
        elif m == 0xFF60:
            _packed_header(m, body, ppm)
        elif m == 0xFF63:               # CRG: read and ignored, as openjpeg ignores it
            if len(body) != 4 * len(st.comps):
                raise _fail("corrupt CRG: openjpeg refuses it too")
        else:
            _other_marker(m, _TILE_ONLY)
    if not cod:
        raise _fail("no COD in the main header")
    if not have_qcd:
        raise _fail("no QCD in the main header")
    if ppm:
        st.ppm = _merge_ppm(ppm)
    default = cod[:4]
    ntiles = st.ntx * st.nty
    if ntiles > len(cs) // 14:
        raise _fail(f"SIZ claims {ntiles} tiles, more than the {len(cs)}-byte stream can hold")
    last: Dict[int, int] = {}
    while True:
        if pos + 2 > len(cs):
            raise _fail("truncated codestream (no EOC)")
        m = _u16(cs, pos)
        if m == 0xFFD9:
            break
        if m != 0xFF90:
            raise _fail(f"expected SOT or EOC at {pos}, found {m:#06x}")
        if pos + 12 > len(cs) or _u16(cs, pos + 2) != 10:
            raise _fail("truncated or corrupt SOT")
        isot, psot, tpsot, _ = struct.unpack(">HIBB", cs[pos + 4:pos + 12])
        if isot >= ntiles:
            raise _fail(f"tile {isot} of {ntiles}")
        end = len(cs) - 2 if psot == 0 else pos + psot
        if end > len(cs) or end < pos + 14:
            raise _fail("a tile-part runs past the end of the codestream")
        tile = st.tiles.get(isot)
        first = tile is None
        if first:
            tile = _Tile(*default, [c.copy() for c in coding], pocs)
            st.tiles[isot] = tile
        if tpsot != tile.seen_parts:
            raise _fail(f"tile {isot}: tile-part {tpsot} out of order")
        tile.seen_parts += 1
        last[isot] = len(last)
        tcod = [tile.scod, tile.prog, tile.layers, tile.mct]
        for m2, body, at in _segments(cs, pos + 12, False):
            if m2 == 0xFF93:
                sod = at + 2
                break
            if m2 in (0xFF90, 0xFFD9):
                raise _fail("tile-part header without SOD")
            if m2 in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D) and not first:
                raise _fail("COD/COC/QCD/QCC in a tile-part other than the first")
            if _coding_marker(st, m2, body, tcod, tile.coding, tile.pocs):
                continue
            if m2 == 0xFF61:
                if st.ppm is not None:
                    raise _fail("PPT after PPM: openjpeg refuses it too")
                _packed_header(m2, body, tile.ppt)
            else:
                _other_marker(m2, _MAIN_ONLY)
        tile.scod, tile.prog, tile.layers, tile.mct = tcod
        if sod > end:
            raise _fail("a tile-part header runs past its tile-part")
        tile.parts.append((tpsot, cs[sod:end]))
        pos = end
        if psot == 0:
            break
    if len(st.tiles) != ntiles:
        missing = sorted(set(range(ntiles)) - set(st.tiles))[:4]
        raise _refuse(f"a codestream with tiles missing ({missing} of {ntiles})")
    st.order = sorted(st.tiles, key=last.__getitem__)
    return st


def _other_marker(m: int, misplaced: Dict[int, str]) -> None:
    if m in _SKIPPED_MARKERS:
        return
    if m in misplaced:
        raise _fail(f"{misplaced[m]} where openjpeg does not take it: PIL refuses it too")
    if m in _REFUSED_MARKERS:
        raise _refuse(f"the {_REFUSED_MARKERS[m]} marker")
    if m in _PART2_MARKERS:
        raise _refuse(f"the Part-2 marker {m:#06x}")
    raise _fail(f"unknown marker {m:#06x}")


# -- tier 2 ---------------------------------------------------------------------------

class _Bits:
    """Packet-header bits (T.800 B.10.1): most significant first, a 0 bit
    stuffed after each 0xFF byte; reading past the tile's data raises."""
    __slots__ = ("data", "pos", "buf", "ct")

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.buf, self.ct = data, pos, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos >= len(self.data):
                raise _fail("a packet header runs past the end of its tile")
            self.buf |= self.data[self.pos]
            self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        if n > 32:
            raise _fail(f"a {n}-bit field in a packet header")
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """End the header (a byte after a final 0xFF is skipped); the
        position of the packet's body."""
        if (self.buf & 0xFF) == 0xFF:
            if self.pos >= len(self.data):
                raise _fail("a packet header runs past the end of its tile")
            self.pos += 1
        self.ct = 0
        return self.pos


class _TagTree:
    """openjpeg's tgt.c decoder: `decode(leaf, threshold)` is whether the
    leaf's value is below the threshold, reading bits until it is known."""
    __slots__ = ("parent", "value", "low")

    def __init__(self, w: int, h: int):
        parent: List[int] = []
        sizes = []
        while True:
            sizes.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        base = 0
        for lvl, (lw, lh) in enumerate(sizes[:-1]):
            nxt = base + lw * lh
            pw = sizes[lvl + 1][0]
            parent.extend(nxt + (j // 2) * pw + i // 2 for j in range(lh) for i in range(lw))
            base = nxt
        parent.extend([-1] * (sizes[-1][0] * sizes[-1][1]))
        self.parent = parent
        self.value = [999] * len(parent)
        self.low = [0] * len(parent)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bits.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return value[node] < threshold


class Block:
    """One code-block: where it lies in its sub-band and what tier 1 reads.
    `segs` holds its codeword segments as [passes, most passes, bytes]."""
    __slots__ = ("comp", "res", "band", "x0", "y0", "x1", "y1", "orient", "mb", "numbps",
                 "passes", "lblock", "chunks", "included", "style", "roishift", "segs")

    def __init__(self, comp, res, band, x0, y0, x1, y1, orient, mb, style=0, roishift=0):
        self.comp, self.res, self.band = comp, res, band
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.orient, self.mb = orient, mb
        self.style, self.roishift = style, roishift
        self.numbps, self.passes, self.lblock = 0, 0, 3
        self.chunks: List[bytes] = []
        self.segs: List[List[int]] = []
        self.included = False

    @property
    def data(self) -> bytes:
        return b"".join(self.chunks)

    @property
    def segments(self) -> List[Tuple[int, int]]:
        """(passes, bytes) of each codeword segment, in order."""
        return [(p, n) for p, _, n in self.segs]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Band:
    __slots__ = ("orient", "x0", "y0", "x1", "y1", "mb", "step")


class _Res:
    __slots__ = ("x0", "y0", "x1", "y1", "ppx", "ppy", "pw", "ph", "bands", "precincts")


def _resolutions(tc: Tuple[int, int, int, int], coding: _Coding, comp: _Comp,
                 c: int) -> List[_Res]:
    """Resolutions, sub-bands and precinct grids of one tile-component
    (T.800 B.5-B.6, as openjpeg's tcd.c lays them out)."""
    x0, y0, x1, y1 = tc
    nl = coding.nl
    out = []
    for r in range(nl + 1):
        res = _Res()
        s = 1 << (nl - r)
        res.x0, res.y0, res.x1, res.y1 = (_ceil_div(x0, s), _ceil_div(y0, s), _ceil_div(x1, s),
                                          _ceil_div(y1, s))
        res.ppx, res.ppy = coding.pp[r]
        px0, py0 = res.x0 >> res.ppx, res.y0 >> res.ppy
        res.pw = 0 if res.x0 == res.x1 else _ceil_div(res.x1, 1 << res.ppx) - px0
        res.ph = 0 if res.y0 == res.y1 else _ceil_div(res.y1, 1 << res.ppy) - py0
        res.bands = []
        for orient in ((0,) if r == 0 else (1, 2, 3)):
            b = _Band()
            b.orient = orient
            if r == 0:
                b.x0, b.y0, b.x1, b.y1 = res.x0, res.y0, res.x1, res.y1
            else:
                xob, yob = orient & 1, orient >> 1
                n = nl - r + 1
                h = 1 << (n - 1)
                b.x0, b.x1 = _ceil_div(x0 - xob * h, 2 * h), _ceil_div(x1 - xob * h, 2 * h)
                b.y0, b.y1 = _ceil_div(y0 - yob * h, 2 * h), _ceil_div(y1 - yob * h, 2 * h)
            expn, mant = coding.step(r, orient)
            b.mb = expn + coding.guard - 1
            if coding.reversible:
                b.step = None
            else:
                b.step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (comp.prec - expn))
            res.bands.append(b)
        res.precincts = {}
        out.append(res)
    return out


class _Precinct:
    __slots__ = ("bands",)   # [(band, cw, blocks, inclusion tree, zero-plane tree)]


def _precinct(res: _Res, r: int, p: int, coding: _Coding, c: int) -> _Precinct:
    prc = res.precincts.get(p)
    if prc is not None:
        return prc
    prc = _Precinct()
    prc.bands = []
    i, j = p % res.pw, p // res.pw
    gx = ((res.x0 >> res.ppx) + i) << res.ppx          # the precinct in resolution coordinates
    gy = ((res.y0 >> res.ppy) + j) << res.ppy
    if r == 0:
        ex, ey = res.ppx, res.ppy
    else:
        ex, ey = res.ppx - 1, res.ppy - 1
        gx, gy = _ceil_div(gx, 2), _ceil_div(gy, 2)
    cw_e, ch_e = min(coding.cbw, ex), min(coding.cbh, ey)
    for b in res.bands:
        if b.x0 == b.x1 or b.y0 == b.y1:
            continue
        px0, py0 = max(gx, b.x0), max(gy, b.y0)
        px1, py1 = min(gx + (1 << ex), b.x1), min(gy + (1 << ey), b.y1)
        bx0, by0 = (px0 >> cw_e) << cw_e, (py0 >> ch_e) << ch_e
        cw = max(0, (_ceil_div(px1, 1 << cw_e) << cw_e) - bx0) >> cw_e
        ch = max(0, (_ceil_div(py1, 1 << ch_e) << ch_e) - by0) >> ch_e
        if px0 >= px1 or py0 >= py1:
            cw = ch = 0
        blocks = []
        for k in range(cw * ch):
            cx, cy = bx0 + (k % cw << cw_e), by0 + (k // cw << ch_e)
            blocks.append(Block(c, r, b, max(cx, px0), max(cy, py0), min(cx + (1 << cw_e), px1),
                                min(cy + (1 << ch_e), py1), b.orient, b.mb, coding.style,
                                coding.roishift))
        trees = (_TagTree(cw, ch), _TagTree(cw, ch)) if blocks else (None, None)
        prc.bands.append((b, blocks) + trees)
    res.precincts[p] = prc
    return prc


def _num_passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


def _max_passes(style: int, segs: List[List[int]]) -> int:
    """The most passes a block's next codeword segment holds (openjpeg's
    opj_t2_init_seg): one under TERMALL; under BYPASS 10 for the first, then
    2 raw passes (significance, refinement) and 1 MQ pass (cleanup) in turn;
    otherwise 109 (T.800 B.10.6)."""
    if style & TERMALL:
        return 1
    if style & BYPASS:
        return 10 if not segs else 2 if segs[-1][1] in (1, 10) else 1
    return 109


class _Headers:
    """Packet headers packed in PPM or PPT segments, read from `pos` on."""
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0


def _read_packet(data: bytes, pos: int, prc: _Precinct, layer: int, scod: int,
                 headers: Optional[_Headers]) -> int:
    """One packet (T.800 B.10): a SOP marker where COD says so, its header
    (from the stream, or from PPM/PPT's `headers`), an EPH marker where COD
    says so, then its code-block bytes. A SOP that is not there is passed
    over, as openjpeg passes it (with a warning); a missing EPH raises, as
    openjpeg fails on it. Returns the position after the packet."""
    if scod & 0x02 and len(data) - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
        pos += 6                                  # SOP: FF91, Lsop, Nsop
    src = data if headers is None else headers.data
    bits = _Bits(src, pos if headers is None else headers.pos)
    news = []
    if bits.bit():                                # else an empty packet
        for band, blocks, incl, zero in prc.bands:
            for k, blk in enumerate(blocks):
                if blk.included:
                    if not bits.bit():
                        continue
                elif not incl.decode(bits, k, layer + 1):
                    continue
                if not blk.included:
                    i = 0
                    while not zero.decode(bits, k, i):
                        i += 1
                        if i > blk.mb + 1:
                            raise _fail("more zero bit-planes than the sub-band has")
                    blk.numbps = blk.mb + 1 - i
                    if blk.numbps + blk.roishift >= 31:
                        raise _fail(f"{blk.numbps + blk.roishift} bit-planes in a code-block: "
                                    f"openjpeg refuses them too")
                    blk.included = True
                n = _num_passes(bits)
                while bits.bit():
                    blk.lblock += 1
                blk.passes += n
                if blk.passes > 164:
                    raise _fail(f"{blk.passes} coding passes in a code-block")
                segs, length = blk.segs, 0
                while n:                          # each segment's length (B.10.7.2)
                    if not segs or segs[-1][0] == segs[-1][1]:
                        segs.append([0, _max_passes(blk.style, segs), 0])
                    seg = segs[-1]
                    take = min(seg[1] - seg[0], n)
                    seg_len = bits.bits(blk.lblock + take.bit_length() - 1)
                    seg[0] += take
                    seg[2] += seg_len
                    length += seg_len
                    n -= take
                news.append((blk, length))
    end = bits.align()
    if scod & 0x04:                               # EPH
        if len(src) - end < 2 or src[end] != 0xFF or src[end + 1] != 0x92:
            raise _fail("no EPH marker after a packet header: openjpeg refuses it (PIL too)")
        end += 2
    if headers is None:
        pos = end
    else:
        headers.pos = end
    for blk, length in news:
        if pos + length > len(data):
            raise _fail("a code-block's bytes run past the end of its tile")
        blk.chunks.append(data[pos:pos + length])
        pos += length
    return pos


def _packet_order(tx: Tuple[int, int, int, int], entries, res_of: List[List[_Res]],
                  comps: List[_Comp]):
    """(layer, resolution, component, precinct) of each packet of a tile in
    the order openjpeg's pi.c visits them (T.800 B.12): one progression
    (prog, first resolution, first component, layers, resolution end,
    component end) of `entries` after another (POC), each packet at its
    first visit only."""
    nc = len(res_of)
    tx0, ty0, tx1, ty1 = tx
    seen = set()

    def steps(cs):
        dx = min(comps[c].dx << (res_of[c][r].ppx + len(res_of[c]) - 1 - r)
                 for c in cs for r in range(len(res_of[c])))
        dy = min(comps[c].dy << (res_of[c][r].ppy + len(res_of[c]) - 1 - r)
                 for c in cs for r in range(len(res_of[c])))
        return dx, dy

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield y, x
                x += dx - x % dx
            y += dy - y % dy

    def precinct_at(c, r, y, x):
        rs = res_of[c]
        if r >= len(rs):
            return None
        res = rs[r]
        lv = len(rs) - 1 - r
        sx, sy = comps[c].dx << lv, comps[c].dy << lv
        rx0, ry0 = _ceil_div(tx0, sx), _ceil_div(ty0, sy)
        rpx, rpy = res.ppx + lv, res.ppy + lv
        if not (y % (comps[c].dy << rpy) == 0 or (y == ty0 and (ry0 << lv) % (1 << rpy))):
            return None
        if not (x % (comps[c].dx << rpx) == 0 or (x == tx0 and (rx0 << lv) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0:
            return None
        if rx0 == _ceil_div(tx1, sx) or ry0 == _ceil_div(ty1, sy):
            return None
        pi = (_ceil_div(x, sx) >> res.ppx) - (rx0 >> res.ppx)
        pj = (_ceil_div(y, sy) >> res.ppy) - (ry0 >> res.ppy)
        return pi + pj * res.pw

    def progression(prog, r0, c0, l1, r1, c1):
        if prog in (0, 1):                          # LRCP, RLCP
            outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if prog == 0 else \
                ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r < len(res_of[c]):
                        res = res_of[c][r]
                        for p in range(res.pw * res.ph):
                            yield l, r, c, p
            return

        def layers(c, r, y, x):
            p = precinct_at(c, r, y, x)
            if p is not None:
                for l in range(l1):
                    yield l, r, c, p

        if prog == 2:                               # RPCL
            dx, dy = steps(range(nc))
            for r in range(r0, r1):
                for y, x in positions(dx, dy):
                    for c in range(c0, c1):
                        yield from layers(c, r, y, x)
        elif prog == 3:                             # PCRL
            dx, dy = steps(range(nc))
            for y, x in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(res_of[c]))):
                        yield from layers(c, r, y, x)
        elif prog == 4:                             # CPRL
            for c in range(c0, c1):
                dx, dy = steps([c])
                for y, x in positions(dx, dy):
                    for r in range(r0, min(r1, len(res_of[c]))):
                        yield from layers(c, r, y, x)

    for prog, r0, c0, l1, r1, c1 in entries:
        if c0 >= nc:                                # openjpeg: no packets from this entry
            continue
        for key in progression(prog, r0, c0, l1, r1, c1):
            if key not in seen:
                seen.add(key)
                yield key


def _tier2(st: _Stream, t: int, ppm: Optional[_Headers] = None
           ) -> Tuple[Tuple[int, int, int, int], List[List[_Res]], List[Block]]:
    """A tile's rectangle, its resolutions and every code-block with its
    bytes; its packet headers from `ppm` (PPM, shared by the tiles in their
    order), from its PPT segments, or from its tile-parts."""
    tile = st.tiles[t]
    xs, ys, xo, yo = st.size
    xt, yt, xto, yto = st.tiling
    p, q = t % st.ntx, t // st.ntx
    tx = (max(xto + p * xt, xo), max(yto + q * yt, yo), min(xto + (p + 1) * xt, xs),
          min(yto + (q + 1) * yt, ys))
    data = b"".join(body for _, body in tile.parts)
    headers = ppm if st.ppm is not None else (
        _Headers(b"".join(tile.ppt[z] for z in sorted(tile.ppt))) if tile.ppt else None)
    res_of = []
    for c, comp in enumerate(st.comps):              # the tile-component (T.800 B-12)
        tc = (_ceil_div(tx[0], comp.dx), _ceil_div(tx[1], comp.dy), _ceil_div(tx[2], comp.dx),
              _ceil_div(tx[3], comp.dy))
        res_of.append(_resolutions(tc, tile.coding[c], comp, c))
    npackets, nblocks = 0, 0
    for c, rs in enumerate(res_of):
        coding = tile.coding[c]
        for r, res in enumerate(rs):
            npackets += res.pw * res.ph
            ex = min(coding.cbw, res.ppx - (r > 0))
            ey = min(coding.cbh, res.ppy - (r > 0))
            for b in res.bands:
                nblocks += ((b.x1 - b.x0 >> ex) + 1 + res.pw) * ((b.y1 - b.y0 >> ey) + 1 + res.ph)
                if coding.roishift >= 31 and b.x1 > b.x0 and b.y1 > b.y0:
                    raise _fail(f"an RGN shift of {coding.roishift}: openjpeg refuses it too")
    npackets *= tile.layers
    room = len(data) + (len(headers.data) - headers.pos if headers is not None else 0)
    if npackets > room:
        raise _fail(f"tile {t} claims {npackets} packets, more than its {room} bytes hold")
    if nblocks > 16 * room + 65536:
        raise _fail(f"tile {t} claims {nblocks} code-blocks, more than its {room} bytes "
                    f"can hold")
    entries = tile.pocs or [(tile.prog, 0, 0, tile.layers, max(map(len, res_of)), len(res_of))]
    entries = [(prog, r0, c0, min(l1, tile.layers), r1, c1)
               for prog, r0, c0, l1, r1, c1 in entries if prog <= 4]
    pos = 0
    for l, r, c, p in _packet_order(tx, entries, res_of, st.comps):
        pos = _read_packet(data, pos, _precinct(res_of[c][r], r, p, tile.coding[c], c), l,
                           tile.scod, headers)
    blocks = [blk for rs in res_of for res in rs for prc in res.precincts.values()
              for _, blks, _, _ in prc.bands for blk in blks]
    return tx, res_of, blocks


# -- tier 1: the plain version ----------------------------------------------------------

# T.800 Table C.2: (Qe, next state after an MPS, after an LPS, switch MPS on an LPS)
_MQ = ((0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
       (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
       (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
       (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
       (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
       (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
       (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
       (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
       (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
       (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
       (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
       (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
_CTX_RL, _CTX_UNI = 17, 18


def _zc_table(orient: int) -> bytes:
    """T.800 Table D.1: the zero-coding context of (h, v, d) significant
    neighbours, at index 15h + 5v + d."""
    out = bytearray(45)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if orient == 3:                                  # HH
                    hv = h + v
                    ctx = (8 if d >= 3 else (7 if hv else 6) if d == 2 else
                           (5 if hv >= 2 else 4 if hv else 3) if d == 1 else
                           (2 if hv >= 2 else hv))
                else:
                    a, b = (v, h) if orient == 1 else (h, v)     # HL swaps h and v
                    ctx = (8 if a == 2 else (7 if b else 6 if d else 5) if a == 1 else
                           4 if b == 2 else 3 if b == 1 else 2 if d >= 2 else d)
                out[15 * h + 5 * v + d] = ctx
    return bytes(out)


_ZC = tuple(_zc_table(o) for o in range(4))
# T.800 Table D.3: (context, XOR bit) of the horizontal and vertical sign
# contributions, at index 3 (H + 1) + V + 1
_SC = ((13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0))


def t1_block_plain(data: bytes, w: int, h: int, orient: int, numbps: int,
                   segments: List[Tuple[int, int]], style: int = 0,
                   roishift: int = 0) -> np.ndarray:
    """One code-block's tier-1 decode (T.800 Annex C and D) as openjpeg's
    opj_t1_decode_cblk: each codeword segment of `segments` ((passes, bytes),
    in the order of `data`) read from its own bytes, by the MQ decoder or,
    under BYPASS, raw for the significance and refinement passes below the
    4th bit-plane; the contexts reset after each MQ pass under RESET, the
    row below a stripe insignificant under VSC, four UNIFORM decisions after
    each cleanup under SEGSYM (PTERM and TERMALL change nothing here). (h, w)
    int32 coefficients at twice their scale, as openjpeg's t1.c holds them,
    from bit-plane numbps + roishift - 1 down (tier1 shifts RGN's back)."""
    out = np.zeros((h, w), np.int32)
    if not segments or w == 0 or h == 0:
        return out
    state = [0] * 19
    mps = [0] * 19

    def reset():
        state[:] = [0] * 19
        mps[:] = [0] * 19
        state[0], state[_CTX_RL], state[_CTX_UNI] = 4, 3, 46

    reset()
    buf = [b""]
    mq = [0, 0, 0, 0]                                  # A, C, CT, the byte C last took

    def bytein():
        b, bp = buf[0], mq[3]
        if b[bp] == 0xFF:
            if b[bp + 1] > 0x8F:
                mq[1] += 0xFF00
                mq[2] = 8
            else:
                mq[3] = bp + 1
                mq[1] += b[bp + 1] << 9
                mq[2] = 7
        else:
            mq[3] = bp + 1
            mq[1] += b[bp + 1] << 8
            mq[2] = 8

    def init(seg: bytes, raw: bool):                   # two 0xFF bytes end each segment
        buf[0] = seg + b"\xff\xff"
        if raw:
            mq[1:] = [0, 0, 0]
            return
        mq[:] = [0x8000, buf[0][0] << 16, 0, 0]
        bytein()
        mq[1] = (mq[1] << 7) & 0xFFFFFFFF
        mq[2] -= 7

    def dec(cx: int) -> int:
        qe, nmps, nlps, switch = _MQ[state[cx]]
        a, c = mq[0] - qe, mq[1]
        if (c >> 16) < qe:
            if a < qe:
                d = mps[cx]
                state[cx] = nmps
            else:
                d = 1 - mps[cx]
                if switch:
                    mps[cx] = d
                state[cx] = nlps
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                mq[0], mq[1] = a, c
                return mps[cx]
            if a < qe:
                d = 1 - mps[cx]
                if switch:
                    mps[cx] = d
                state[cx] = nlps
            else:
                d = mps[cx]
                state[cx] = nmps
        while True:                                    # RENORMD
            if mq[2] == 0:
                mq[1] = c
                bytein()
                c = mq[1]
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            mq[2] -= 1
            if a & 0x8000:
                break
        mq[0], mq[1] = a, c
        return d

    def raw() -> int:                                  # opj_mqc_raw_decode
        if mq[2] == 0:
            b, bp = buf[0], mq[3]
            if mq[1] == 0xFF and b[bp] > 0x8F:
                mq[2] = 8
            else:
                mq[2] = 7 if mq[1] == 0xFF else 8
                mq[1] = b[bp]
                mq[3] = bp + 1
        mq[2] -= 1
        return (mq[1] >> mq[2]) & 1

    S = w + 2
    n = S * (h + 2)
    sig, neg, pi, refined = bytearray(n), bytearray(n), bytearray(n), bytearray(n)
    mag = [0] * n
    zc = _ZC[orient]
    vsc = bool(style & VSC)

    def context(p, cut):                               # cut: the row below is not seen (VSC)
        below = 0 if cut else 5 * sig[p + S] + sig[p + S - 1] + sig[p + S + 1]
        return zc[15 * (sig[p - 1] + sig[p + 1]) + 5 * sig[p - S] + below
                  + sig[p - S - 1] + sig[p - S + 1]]

    def sign(p, cut):
        hc = (sig[p - 1] and (-1 if neg[p - 1] else 1)) + (sig[p + 1] and (-1 if neg[p + 1] else 1))
        vc = (sig[p - S] and (-1 if neg[p - S] else 1)) + (
            0 if cut else sig[p + S] and (-1 if neg[p + S] else 1))
        ctx, xor = _SC[3 * (max(-1, min(1, hc)) + 1) + max(-1, min(1, vc)) + 1]
        return dec(ctx) ^ xor

    def scan():
        for y0 in range(0, h, 4):
            for x in range(w):
                p = (y0 + 1) * S + x + 1
                for k in range(min(4, h - y0)):
                    yield p, vsc and k == 3
                    p += S

    bpno = numbps + roishift                           # openjpeg's bpno_plus_one
    kind = 2                                           # the first pass is a cleanup
    start = 0
    for seg_passes, seg_len in segments:
        is_raw = bool(style & BYPASS) and kind < 2 and bpno <= numbps - 4
        init(bytes(data[start:start + seg_len]), is_raw)
        start += seg_len
        for _ in range(seg_passes):
            if bpno < 1:
                break
            bp = bpno - 1
            oph = 3 << bp                              # 1.5 of this plane, at twice the scale
            if kind == 0:                              # significance propagation
                for p, cut in scan():
                    if not sig[p] and context(p, cut):
                        pi[p] = 1
                        if is_raw:
                            if raw():
                                neg[p] = raw()
                                mag[p] = oph
                                sig[p] = 1
                        elif dec(context(p, cut)):
                            neg[p] = sign(p, cut)
                            mag[p] = oph
                            sig[p] = 1
            elif kind == 1:                            # magnitude refinement
                half = 1 << bp
                for p, cut in scan():
                    if sig[p] and not pi[p]:
                        if is_raw:
                            bit = raw()
                        else:
                            if refined[p]:
                                ctx = 16
                            else:
                                around = (sig[p - 1] | sig[p + 1] | sig[p - S] | sig[p - S - 1]
                                          | sig[p - S + 1])
                                if not cut:
                                    around |= sig[p + S] | sig[p + S - 1] | sig[p + S + 1]
                                ctx = 15 if around else 14
                            bit = dec(ctx)
                        mag[p] += half if bit else -half
                        refined[p] = 1
            else:                                      # cleanup, with run-length mode
                for y0 in range(0, h, 4):
                    rows = min(4, h - y0)
                    for x in range(w):
                        p0 = (y0 + 1) * S + x + 1
                        start_k = 0
                        if rows == 4 and not (pi[p0] or pi[p0 + S] or pi[p0 + 2 * S]
                                              or pi[p0 + 3 * S]
                                              or _any_neighbour(sig, p0, S, vsc)):
                            if not dec(_CTX_RL):
                                continue
                            k = dec(_CTX_UNI) << 1
                            k |= dec(_CTX_UNI)
                            p = p0 + k * S
                            neg[p] = sign(p, vsc and k == 3)
                            mag[p] = oph
                            sig[p] = 1
                            start_k = k + 1
                        for k in range(start_k, rows):
                            p = p0 + k * S
                            cut = vsc and k == 3
                            if not sig[p] and not pi[p] and dec(context(p, cut)):
                                neg[p] = sign(p, cut)
                                mag[p] = oph
                                sig[p] = 1
                for i in range(n):
                    pi[i] = 0
                if style & SEGSYM:
                    for _ in range(4):
                        dec(_CTX_UNI)
            if style & RESET and not is_raw:
                reset()
            kind += 1
            if kind == 3:
                kind = 0
                bpno -= 1
    body = np.array(mag, np.int64).reshape(h + 2, S)[1:-1, 1:-1]
    negs = np.frombuffer(bytes(neg), np.uint8).reshape(h + 2, S)[1:-1, 1:-1]
    out[:] = np.where(negs == 1, -body, body)
    return out


def _any_neighbour(sig: bytearray, p0: int, S: int, vsc: bool) -> bool:
    """Any significant coefficient in a stripe column of four or around it
    (under VSC, not the row below the stripe)."""
    for k in range(-1, 4 if vsc else 5):
        p = p0 + k * S
        if sig[p - 1] or sig[p] or sig[p + 1]:
            return True
    return False


# -- tier 1 in C++ ----------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
calls = 0          # calls into csrc/jpeg2000_t1.cc
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from shmgan_tpu_torch.runtime.build import load

            lib = load("jpeg2000_t1")
            lib.shm_j2k_t1_decode.argtypes = [
                ctypes.c_char_p, _I64P, _I32P, _I32P, ctypes.c_int, _I64P, _I32P, ctypes.c_int]
            lib.shm_j2k_t1_decode.restype = ctypes.c_int
            _lib = lib
    return _lib


def _roi_shift(v: np.ndarray, shift: int) -> np.ndarray:
    """RGN's max-shift, as opj_t1_clbl_decode_processor undoes it: each
    coefficient of magnitude 2^shift or more (at twice its scale) shifted
    down by `shift`."""
    mag = np.abs(v)
    return np.where(mag >= (1 << shift), np.where(v < 0, -(mag >> shift), mag >> shift), v
                    ).astype(np.int32)


def tier1(blocks: List[Block], plain: bool = False) -> List[np.ndarray]:
    """Every block's coefficients ((h, w) int32, twice their scale), by the
    C++ decoder, or by `t1_block_plain` when `plain` is set; RGN's shift
    undone after either."""
    global calls
    if plain:
        outs = [t1_block_plain(b.data, b.x1 - b.x0, b.y1 - b.y0, b.orient, b.numbps,
                               b.segments, b.style, b.roishift) for b in blocks]
    elif not blocks:
        return []
    else:
        lib = _library()
        datas = [b.data for b in blocks]
        offsets = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum([len(d) for d in datas], out=offsets[1:])
        segs = np.array([s for b in blocks for s in b.segments], np.int32).reshape(-1, 2)
        first = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum([len(b.segs) for b in blocks], out=first[1:])
        params = np.array([(b.x1 - b.x0, b.y1 - b.y0, b.orient, b.numbps, b.roishift, b.style,
                            first[i], len(b.segs)) for i, b in enumerate(blocks)],
                          np.int32).reshape(-1, 8)
        sizes = params[:, 0].astype(np.int64) * params[:, 1]
        out_off = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum(sizes, out=out_off[1:])
        out = np.zeros(int(out_off[-1]), np.int32)
        bad = lib.shm_j2k_t1_decode(b"".join(datas), offsets.ctypes.data_as(_I64P),
                                    params.ctypes.data_as(_I32P), segs.ctypes.data_as(_I32P),
                                    len(segs), out_off.ctypes.data_as(_I64P),
                                    out.ctypes.data_as(_I32P), len(blocks))
        with _lock:
            calls += 1
        if bad:
            raise _fail(f"code-block {bad - 1}: tier 1 refused its parameters")
        outs = [out[out_off[i]:out_off[i + 1]].reshape(int(params[i, 1]), int(params[i, 0]))
                for i in range(len(blocks))]
    return [_roi_shift(v, b.roishift) if b.roishift else v for b, v in zip(blocks, outs)]


# -- reconstruction ---------------------------------------------------------------------

def _lift_first(f: np.ndarray, s: np.ndarray, step) -> None:
    """One lifting step on the samples at even relative positions (rows of
    `f`), from their neighbours at odd ones (`s`), whole-sample symmetric at
    both ends: f[i] gets step(f[i], s[i - 1], s[i])."""
    nf, ns = len(f), len(s)
    f[0] = step(f[0], s[0], s[0])
    f[1:ns] = step(f[1:ns], s[:ns - 1], s[1:ns])
    if nf > ns:
        f[ns] = step(f[ns], s[ns - 1], s[ns - 1])


def _lift_second(s: np.ndarray, f: np.ndarray, step) -> None:
    """The same on the samples at odd relative positions: s[j] gets
    step(s[j], f[j], f[j + 1])."""
    nf, ns = len(f), len(s)
    s[:nf - 1] = step(s[:nf - 1], f[:nf - 1], f[1:nf])
    if ns == nf:
        s[ns - 1] = step(s[ns - 1], f[nf - 1], f[nf - 1])


def _scaled(c):
    return lambda x, left, right: x + (left + right) * c


def _inverse_1d(low: np.ndarray, high: np.ndarray, start: int, reversible: bool,
                axis: int) -> np.ndarray:
    """One level of the inverse DWT along `axis`: low- and high-pass samples
    of a signal whose first sample lies at absolute coordinate `start` (even
    coordinates are low-pass) -> the interleaved signal. 5/3 in int64:
    x_even -= (left + right + 2) >> 2, then x_odd += (left + right) >> 1;
    9/7 in float32 as openjpeg's opj_v8dwt_decode: both bands scaled, then
    four steps of x += (left + right) * c."""
    low, high = np.moveaxis(low, axis, 0), np.moveaxis(high, axis, 0)
    n = len(low) + len(high)
    out = np.empty((n,) + low.shape[1:], low.dtype)
    first = start & 1                                  # 1: the first sample is high-pass
    if n == 1:
        if first and reversible:                       # openjpeg: a lone high sample, / 2
            high = np.where(high < 0, -((-high) >> 1), high >> 1)
        out[:] = high if first else low
        return np.moveaxis(out, 0, axis)
    if n:
        low, high = low.copy(), high.copy()
        if reversible:
            steps = ((0, lambda x, l, r: x - ((l + r + 2) >> 2)),
                     (1, lambda x, l, r: x + ((l + r) >> 1)))
        else:
            low *= _K
            high *= _TWO_INV_K
            steps = tuple(zip((0, 1, 0, 1), map(_scaled, _LIFT97)))
        for band, step in steps:
            mine, other = (low, high) if band == 0 else (high, low)
            if (band == 0) == (first == 0):            # this band holds the even positions
                _lift_first(mine, other, step)
            else:
                _lift_second(mine, other, step)
        out[first::2] = low
        out[1 - first::2] = high
    return np.moveaxis(out, 0, axis)


def _tile_component(res: List[_Res], coefs: Dict[int, np.ndarray], reversible: bool
                    ) -> np.ndarray:
    """Dequantise each sub-band and run the inverse DWT, rows then columns
    at each level, as openjpeg: the tile-component's samples before the
    colour transform (int64, or float32)."""
    def band(b: _Band) -> np.ndarray:
        v = coefs.get(id(b))
        if v is None:
            v = np.zeros((b.y1 - b.y0, b.x1 - b.x0), np.int32)
        if reversible:
            v = v.astype(np.int64)
            return np.where(v < 0, -((-v) >> 1), v >> 1)
        return v.astype(np.float32) * (b.step * np.float32(0.5))

    a = band(res[0].bands[0])
    for r in range(1, len(res)):
        rr = res[r]
        hl, lh, hh = (band(b) for b in rr.bands)
        top = _inverse_1d(a, hl, rr.x0, reversible, 1)
        bottom = _inverse_1d(lh, hh, rr.x0, reversible, 1)
        a = _inverse_1d(top, bottom, rr.y0, reversible, 0)
    return a


def _samples(planes: List[np.ndarray], comps: List[_Comp], mct: int, reversible: bool
             ) -> List[np.ndarray]:
    """Inverse RCT or ICT (skipped below three components, as openjpeg skips
    it; over the first three planes' samples in order, which openjpeg
    requires to be as many), the DC level shift, the clamp (openjpeg's
    opj_tcd_dc_level_shift_decode; float samples rounded by lrintf first)."""
    planes = list(planes)
    if mct and len(planes) >= 3:
        if len({p.size for p in planes[:3]}) > 1:
            raise _fail("the colour transform over components of other sizes: openjpeg "
                        "refuses the tile (PIL too)")
        shapes = [p.shape for p in planes[:3]]
        y, u, v = (p.reshape(-1) for p in planes[:3])
        if reversible:
            g = y - ((u + v) >> 2)
            out3 = [v + g, g, u + g]
        else:
            out3 = [y + v * np.float32(1.402),
                    y - u * np.float32(0.34413) - v * np.float32(0.71414),
                    y + u * np.float32(1.772)]
        planes[:3] = [p.reshape(s) for p, s in zip(out3, shapes)]
    out = []
    for p, comp in zip(planes, comps):
        lo, hi = ((-(1 << (comp.prec - 1)), (1 << (comp.prec - 1)) - 1) if comp.sgnd
                  else (0, (1 << comp.prec) - 1))
        shift = 0 if comp.sgnd else 1 << (comp.prec - 1)
        # clamp(lrintf(v) + shift) is rint(clamp(v)) + shift: the bounds are integers
        p = np.clip(p, lo - shift, hi - shift)
        if p.dtype == np.float32:
            p = np.rint(p).astype(np.int64)
        out.append(p + shift)
    return out


def _csize(comp: _Comp) -> int:
    """Bytes a sample takes in openjpeg's tile buffer (3 become 4)."""
    size = (comp.prec + 7) >> 3
    return 4 if size == 3 else size


def _shift(raw: np.ndarray, comp: _Comp, bits: int) -> np.ndarray:
    """Pillow's j2ku_shift(offset + word, shift): a word as openjpeg stores
    it (unsigned), offset by half the range when signed, shifted to `bits`
    (rounding half up when it narrows)."""
    shift = bits - comp.prec
    offset = (1 << (comp.prec - 1)) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        x = (raw + offset) >> -shift
    else:
        x = (raw + offset) << shift
    return (x & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _unpack(v: np.ndarray, comp: _Comp, bits: int) -> np.ndarray:
    """A component's samples as Pillow's unpacker reads them from openjpeg's
    tile buffer (`_csize` bytes each), through `_shift`."""
    return _shift(v & ((1 << (8 * _csize(comp))) - 1), comp, bits)


def _subsampled(planes: List[np.ndarray], comps: List[_Comp], tw: int, th: int
                ) -> List[np.ndarray]:
    """Each component as Pillow's j2ku_srgb_rgb and j2ku_sycc_rgb read
    sub-sampled ones: openjpeg writes each tile-component's samples, one
    after another, into Pillow's tile buffer, zeroed for each tile to the
    larger of that and every component at the tile's full size; Pillow takes
    component n at byte sum(csize * (tw / dx) * (th / dy)) of those before
    it, and the sample of pixel (x, y) at (y / dy) * (tw / dx) + x / dx of
    it, in C's integer division (so an odd edge may read the next
    component's samples, or zeros). -> (th, tw) uint8 planes."""
    sizes = [_csize(c) for c in comps]
    buf = np.zeros(max(sum(s * p.size for s, p in zip(sizes, planes)), sum(sizes) * tw * th),
                   np.uint8)
    pos = 0
    for s, p, c in zip(sizes, planes, comps):
        words = (p & ((1 << (8 * s)) - 1)).astype(f"<u{s}")
        buf[pos:pos + s * p.size] = words.reshape(-1).view(np.uint8)
        pos += s * p.size
    out, start = [], 0
    ys, xs = np.arange(th)[:, None], np.arange(tw)[None, :]
    for s, c in zip(sizes, comps):
        row = tw // c.dx
        at = start + s * ((ys // c.dy) * row + xs // c.dx)
        word = sum(buf[at + k].astype(np.int64) << (8 * k) for k in range(s))
        out.append(_shift(word, c, 8))
        start += s * row * (th // c.dy)
    return out


# Pillow's ConvertYCbCr.c: Cr's and Cb's terms of R, G and B in 6-bit fixed
# point, (v - 128) * c * 64 truncated after adding a half
_YCC_TERMS = [np.trunc((np.arange(256) - 128) * c * 64 + 0.5).astype(np.int64)
              for c in (1.40200, -0.34414, -0.71414, 1.77200)]


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB (what Jpeg2KDecode.c's sYCC
    unpackers call): (..., 3) uint8 YCbCr -> RGB."""
    r_cr, g_cb, g_cr, b_cb = _YCC_TERMS
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (r_cr[cr] >> 6), y + ((g_cb[cb] + g_cr[cr]) >> 6), y + (b_cb[cb] >> 6)],
                   axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb: nk - nk * c / 255 with nk = 255 - k, in MULDIV255."""
    nk = 255 - cmyk[..., 3:].astype(np.int64)
    t = cmyk[..., :3].astype(np.int64) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _to_rgb(mode: str, unpacker: str, planes: List[np.ndarray], comps: List[_Comp],
            palette: Optional[np.ndarray], tile: Tuple[int, int]) -> np.ndarray:
    """A tile's samples through Pillow's unpacker into `mode`, then
    `convert("RGB")`."""
    if unpacker == "grey16":
        g = np.minimum(_unpack(planes[0], comps[0], 16), 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=2)
    if unpacker == "grey":                               # alpha, if any, dropped
        g = _unpack(planes[0], comps[0], 8)
        if mode in ("P", "PA"):
            table = np.zeros((256, 3), np.uint8)
            table[:len(palette)] = palette[:256]
            return table[g]
        return np.repeat(g[..., None], 3, axis=2)
    if any(c.dx != 1 or c.dy != 1 for c in comps):
        chans = np.stack(_subsampled(planes, comps, *tile)[:4], axis=-1)
    else:
        chans = np.stack([_unpack(p, c, 8) for p, c in zip(planes, comps)][:4], axis=-1)
    if unpacker == "sycc":
        return _ycbcr_to_rgb(chans[..., :3])
    if mode == "CMYK":
        return _cmyk_to_rgb(chans)
    return chans[..., :3]


def _colour_space(colour: int, comps: List[_Comp]) -> int:
    """Pillow's colour space of an image openjpeg gives it unspecified (a
    raw codestream) or unknown (a JP2 with no enumerated colour space it
    knows, an ICC profile, or no colr): sYCC where the first component is at
    full size and the second or third sub-sampled, else grey below three
    components and sRGB from three."""
    if colour != _CS_UNSPECIFIED:
        return colour
    full = lambda c: c.dx == 1 and c.dy == 1  # noqa: E731
    if len(comps) >= 3 and full(comps[0]) and not (full(comps[1]) and full(comps[2])):
        return _CS_SYCC
    return _CS_GRAY if len(comps) <= 2 else _CS_SRGB


def _image(cs: bytes, mode: Optional[str], colour: int, size: Optional[Tuple[int, int]],
           palette: Optional[np.ndarray]) -> np.ndarray:
    st = _parse(cs)
    xs, ys, xo, yo = st.size
    nc = len(st.comps)
    if mode is None:                                   # a raw codestream: PIL's _parse_codestream
        mode = {1: "I;16" if st.comps[0].prec > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
    elif size != (xs - xo, ys - yo):
        raise _fail(f"ihdr's size {size} is not SIZ's {(xs - xo, ys - yo)}")
    colour = _colour_space(colour, st.comps)
    unpacker = _UNPACKERS.get((mode, colour, nc))
    if unpacker is None:
        raise _fail(f"mode {mode} from {nc} components in colour space {_CS_NAMES[colour]}: "
                    f"PIL refuses it too (no unpacker)")
    if unpacker not in ("rgb", "sycc") and any(c.dx != 1 or c.dy != 1 for c in st.comps):
        raise _fail(f"mode {mode} from sub-sampled components: PIL refuses it too (its "
                    f"unpacker takes none)")
    ppm = _Headers(st.ppm) if st.ppm is not None else None
    tiles = [(t,) + _tier2(st, t, ppm) for t in st.order]
    out = np.zeros((ys - yo, xs - xo, 3), np.uint8)
    blocks = [b for *_, bs in tiles for b in bs if b.passes]
    decoded = {id(b): v for b, v in zip(blocks, tier1(blocks))}
    for t, tx, res_of, bs in tiles:
        tile = st.tiles[t]
        if tile.mct and nc >= 3 and len({tile.coding[c].reversible for c in range(3)}) > 1:
            raise _refuse("the multiple component transform over reversible and "
                          "irreversible components")
        planes = []
        for c in range(nc):
            coefs: Dict[int, np.ndarray] = {}
            for b in bs:
                if b.comp == c:
                    band = b.band
                    arr = coefs.get(id(band))
                    if arr is None:
                        arr = coefs[id(band)] = np.zeros((band.y1 - band.y0, band.x1 - band.x0),
                                                         np.int32)
                    v = decoded.get(id(b))
                    if v is not None:
                        arr[b.y0 - band.y0:b.y1 - band.y0, b.x0 - band.x0:b.x1 - band.x0] = v
            planes.append(_tile_component(res_of[c], coefs, tile.coding[c].reversible))
        samples = _samples(planes, st.comps, tile.mct, tile.coding[0].reversible)
        rgb = _to_rgb(mode, unpacker, samples, st.comps, palette,
                      (tx[2] - tx[0], tx[3] - tx[1]))
        out[tx[1] - yo:tx[3] - yo, tx[0] - xo:tx[2] - xo] = rgb
    return out


def _split(data: bytes):
    """(codestream, mode, colour space, ihdr size, palette) of a JP2 file or
    a raw codestream."""
    data = bytes(data)
    if data.startswith(JP2_SIGNATURE):
        h, cs = _read_jp2(data)
        if h.nc != 0 and len(cs) >= 42 and _u16(cs, 40) != h.nc:
            raise _fail(f"ihdr's {h.nc} components are not SIZ's {_u16(cs, 40)}")
        return cs, h.mode, h.colour, h.size, h.palette
    if data.startswith(J2K_SIGNATURE):
        return data, None, _CS_UNSPECIFIED, None, None
    raise _fail("no JP2 signature box or codestream SOC/SIZ")


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """A JP2 file or a raw JPEG 2000 codestream -> (H, W, 3) uint8, PIL's
    `convert("RGB")` pixels."""
    try:
        cs, mode, colour, size, palette = _split(data)
        return _image(cs, mode, colour, size, palette)
    except (IndexError, struct.error) as e:
        raise _fail(f"corrupt stream ({e})") from None


def tier1_inputs(data: bytes) -> List[Block]:
    """Every code-block of every tile with the bytes and passes tier 1 reads
    (parsed, no tier 1 run), for holding the C++ to the plain version."""
    cs = _split(data)[0]
    st = _parse(cs)
    ppm = _Headers(st.ppm) if st.ppm is not None else None
    return [b for t in st.order for b in _tier2(st, t, ppm)[2] if b.passes]
