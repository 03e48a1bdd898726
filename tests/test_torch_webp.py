"""The port's WebP decoder (data/webp.py) against PIL (libwebp's
WebPAnimDecoder), on the CPU, pixel for pixel: lossless files PIL writes at
methods 0, 3 and 6 (with `exact=True`), on contents that reach every
transform, meta prefix codes and the colour cache, and palette-sized images
(colour indexing with pixel bundling); lossy files at qualities 10, 50, 90
and 100 and methods 0, 4 and 6; RGBA, lossy and lossless, with zero and
semi-transparent alpha; a two-frame animation (its first frame), a first
frame at an offset on a larger canvas; ICC, EXIF and XMP chunks; sizes 1x1,
17x23 and not a multiple of 16. VP8 key frames of options libwebp's
encoder never writes (the simple filter, sharpness, filter deltas,
segments with absolute and relative values, 2, 4 and 8 token partitions,
skipped macroblocks, coefficient probability updates, every intra mode)
come from a small random-frame writer below. Truncated and corrupt files
raise ValueError."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs, webp
from shmgan_tpu_torch.data.webp import decode_webp


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0), 128 + 80 * np.cos(yy / 5.0),
                    (2 * xx + yy) % 256], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _contents(h, w, seed):
    """Images on which libwebp's lossless encoder picks every predictor
    mode, meta prefix codes and the colour cache between them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    pattern = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx ^ yy) % 256], -1)
    mixed = pattern.copy()
    mixed[h // 2:] = rng.integers(0, 16, (h - h // 2, w, 3)) * 16
    tiles = rng.integers(0, 256, (8, 3))[rng.integers(0, 8, (-(-h // 8), -(-w // 8)))]
    tiles = tiles.repeat(8, 0).repeat(8, 1)[:h, :w] + rng.integers(-2, 3, (h, w, 3))
    return {"photo": _photo(h, w, seed), "pattern": pattern, "mixed": mixed,
            "tiles": np.clip(tiles, 0, 255)}


def _webp(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8), mode).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _same_as_pil(data):
    got = decode_webp(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(codecs.decode(data), got)


# -- lossless ---------------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("content", ["photo", "pattern", "mixed", "tiles"])
def test_lossless_every_method(content, method):
    _same_as_pil(_webp(_contents(64, 80, seed=method)[content], lossless=True, method=method,
                       exact=True))


def test_lossless_reaches_every_transform_and_code_kind(monkeypatch):
    """The files of test_lossless_every_method, a palette image and a 64x96
    photo at method 6 (where libwebp picks predictor mode 13) use all four
    transforms, all 14 predictor modes, meta prefix codes and the colour
    cache."""
    seen = set()
    pixels, predict, undo = webp._pixels, webp._inverse_predictor, webp._undo_transform

    def spy_pixels(br, w, h, groups, meta, meta_bits, mw, cache_bits):
        seen.update({"meta"} if meta is not None else set())
        seen.update({"cache"} if cache_bits else set())
        return pixels(br, w, h, groups, meta, meta_bits, mw, cache_bits)

    def spy_predict(res, modes):
        seen.update(f"mode {m}" for m in np.unique(modes).tolist())
        return predict(res, modes)

    def spy_undo(kind, bits, sub, tw, px):
        seen.add(f"transform {kind}")
        return undo(kind, bits, sub, tw, px)
    monkeypatch.setattr(webp, "_pixels", spy_pixels)
    monkeypatch.setattr(webp, "_inverse_predictor", spy_predict)
    monkeypatch.setattr(webp, "_undo_transform", spy_undo)
    for method in (0, 3, 6):
        for img in _contents(64, 80, seed=method).values():
            decode_webp(_webp(img, lossless=True, method=method, exact=True))
    rng = np.random.default_rng(11)
    decode_webp(_webp(rng.integers(0, 256, (11, 3))[rng.integers(0, 11, (17, 23))],
                      lossless=True, method=6))
    _same_as_pil(_webp(_photo(64, 96, seed=1), lossless=True, method=6, exact=True))
    want = {"meta", "cache"} | {f"mode {m}" for m in range(14)} | {
        f"transform {k}" for k in range(4)}
    assert want <= seen, sorted(want - seen)


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 200])
@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (40, 56)], ids=str)
def test_lossless_palettes_bundle_pixels(colours, shape):
    """Colour indexing: 8, 4, 2 or 1 pixels a bundled pixel."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 3))
    img = palette[rng.integers(0, colours, shape)]
    _same_as_pil(_webp(img, lossless=True, method=6))


# -- lossy ------------------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [10, 50, 90, 100])
def test_lossy_every_quality_and_method(quality, method):
    _same_as_pil(_webp(_photo(40, 56, seed=quality), quality=quality, method=method))


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (33, 70), (64, 48)], ids=str)
@pytest.mark.parametrize("lossless", [False, True])
def test_odd_sizes(shape, lossless):
    _same_as_pil(_webp(_photo(*shape, seed=shape[0]), quality=75, lossless=lossless))


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_rgba_keeps_the_colour_under_any_alpha(lossless, exact):
    """Alpha 0 and semi-transparent alpha: the RGB PIL reads (libwebp writes
    RGBA without premultiplying) is the RGB decoded."""
    rgb = _photo(37, 45, seed=3)
    alpha = np.random.default_rng(4).integers(0, 256, (37, 45, 1))
    alpha[:10], alpha[10:20] = 0, 255
    _same_as_pil(_webp(np.concatenate([rgb, alpha], -1), "RGBA", lossless=lossless, exact=exact,
                       quality=70))


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame(lossless):
    frames = [Image.fromarray(_photo(37, 45, seed=s)) for s in (5, 6)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:],
                   lossless=lossless, duration=100)
    assert buf.getvalue()[30:34] == b"ANIM"
    _same_as_pil(buf.getvalue())


def _riff(chunks):
    body = b"".join(k + struct.pack("<I", len(v)) + v + b"\0" * (len(v) & 1) for k, v in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _bitstream(data):
    """The VP8 or VP8L chunk of a simple file: (fourcc, payload)."""
    (n,) = struct.unpack_from("<I", data, 16)
    return data[12:16], data[20:20 + n]


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_frame_at_an_offset(lossless):
    """A first frame smaller than the canvas, at (10, 6): the rest of the
    canvas is transparent black."""
    kind, payload = _bitstream(_webp(_photo(20, 26, seed=7), lossless=lossless))
    w, h, cw, ch = 26, 20, 50, 40
    u24 = lambda v: v.to_bytes(3, "little")        # noqa: E731
    vp8x = bytes([0x02]) + b"\0" * 3 + u24(cw - 1) + u24(ch - 1)
    anmf = (u24(10 // 2) + u24(6 // 2) + u24(w - 1) + u24(h - 1) + u24(100) + b"\x00"
            + kind + struct.pack("<I", len(payload))
            + payload + b"\0" * (len(payload) & 1))
    _same_as_pil(_riff([(b"VP8X", vp8x), (b"ANIM", b"\0" * 6), (b"ANMF", anmf)]))


def test_metadata_chunks_are_skipped():
    data = _webp(_photo(24, 24, seed=8), icc_profile=b"\0" * 200, exif=b"Exif\0\0" + bytes(20),
                 xmp=b"<x/>")
    assert data[12:16] == b"VP8X" and b"ICCP" in data and b"EXIF" in data
    _same_as_pil(data)


# -- VP8 frames of every header option --------------------------------------------

class BoolEncoder:
    """RFC 6386 section 7.3."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def flag_value(self, v, n):
        self.put(128, v != 0)
        if v:
            self.literal(abs(v), n)
            self.put(128, v < 0)

    def finish(self):
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tokens(e, bp, ctx, first, c):
    """Encode one block's levels c (16, zigzag order) from `first`, as
    libwebp's GetCoeffs reads them. Returns whether one is nonzero."""
    nz = [n for n in range(first, 16) if c[n]]
    last = nz[-1] if nz else -1
    n, p = first, bp[first][ctx]
    while n < 16:
        if n > last:
            e.put(p[0], 0)
            return last >= first
        e.put(p[0], 1)
        while c[n] == 0:
            e.put(p[1], 0)
            n += 1
            p = bp[n][0]
        e.put(p[1], 1)
        v = abs(c[n])
        if v == 1:
            e.put(p[2], 0)
            nxt = bp[n + 1][1]
        else:
            e.put(p[2], 1)
            if v <= 4:
                e.put(p[3], 0)
                e.put(p[4], v > 2)
                if v > 2:
                    e.put(p[5], v - 3)
            elif v <= 10:
                e.put(p[3], 1)
                e.put(p[6], 0)
                e.put(p[7], v > 6)
                if v <= 6:
                    e.put(159, v - 5)
                else:
                    e.put(165, (v - 7) >> 1)
                    e.put(145, (v - 7) & 1)
            else:
                e.put(p[3], 1)
                e.put(p[6], 1)
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                e.put(p[8], cat >> 1)
                e.put(p[9 + (cat >> 1)], cat & 1)
                extra = v - 3 - (8 << cat)
                probs = webp._CAT_PROBS[cat]
                for i, prob in enumerate(probs):
                    e.put(prob, (extra >> (len(probs) - 1 - i)) & 1)
            nxt = bp[n + 1][2]
        e.put(128, c[n] < 0)
        n += 1
        p = nxt
    return True


def vp8_frame(w, h, seed, *, simple=False, level=24, sharpness=0, ref_delta=None,
              mode_delta=None, parts_log2=0, segments=None, base_q=20, dq=(0, 0, 0, 0, 0),
              skip_prob=None, i4_share=0.5, density=0.2, big=False, updates=0.02):
    """A VP8 key frame's bytes (the "VP8 " chunk payload)."""
    rng = np.random.default_rng(seed)
    e = BoolEncoder()
    e.put(128, 0)
    e.put(128, 0)
    e.put(128, segments is not None)
    seg_probs = None
    if segments is not None:
        absolute, quants, filters, seg_probs = segments
        e.put(128, seg_probs is not None)
        e.put(128, 1)
        e.put(128, absolute)
        for v in quants:
            e.flag_value(v, 7)
        for v in filters:
            e.flag_value(v, 6)
        if seg_probs is not None:
            for p in seg_probs:
                e.put(128, p != 255)
                if p != 255:
                    e.literal(p, 8)
    e.put(128, simple)
    e.literal(level, 6)
    e.literal(sharpness, 3)
    e.put(128, ref_delta is not None)
    if ref_delta is not None:
        e.put(128, 1)
        for v in ref_delta:
            e.flag_value(v, 6)
        for v in mode_delta:
            e.flag_value(v, 6)
    e.literal(parts_log2, 2)
    e.literal(base_q, 7)
    for v in dq:
        e.flag_value(v, 4)
    e.put(128, 0)
    proba = np.frombuffer(webp._COEFFS_PROBA0, np.uint8).reshape(4, 8, 3, 11).astype(int).tolist()
    update = np.frombuffer(webp._COEFFS_UPDATE_PROBA, np.uint8).reshape(4, 8, 3, 11).tolist()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    change = rng.random() < updates
                    e.put(update[t][b][c][p], change)
                    if change:
                        proba[t][b][c][p] = int(rng.integers(1, 256))
                        e.literal(proba[t][b][c][p], 8)
    bands = [[proba[t][webp._BANDS[n]] for n in range(17)] for t in range(4)]
    e.put(128, skip_prob is not None)
    if skip_prob is not None:
        e.literal(skip_prob, 8)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    nparts = 1 << parts_log2
    parts = [BoolEncoder() for _ in range(nparts)]
    bmodes = np.frombuffer(webp._BMODES_PROBA, np.uint8).reshape(10, 10, 9).tolist()
    intra_top = [[0] * 4 for _ in range(mbw)]
    nz_top = [[0] * 9 for _ in range(mbw)]
    def seg_q(seg):
        if segments is None:
            return base_q
        return segments[1][seg] + (0 if segments[0] else base_q)

    def levels(n, first, scale):
        c = [0] * 16
        for k in range(first, 16):
            if rng.random() < density * (1.0 if k < 6 else 0.4):
                mag = int(rng.choice([1, 1, 1, 2, 3, 4, 6, 9, 15, 30, 60, 120]))
                if big and rng.random() < 0.1:
                    mag = int(rng.integers(67, 300))
                # dequantised levels past 2047 leave the range libwebp's SIMD
                # transforms agree with its C ones on
                cap = 2047 // webp._AC_TABLE[min(max(q + 5, 0), 127)] // (4 if n == 17 else 1)
                c[k] = min(mag, scale, cap) * (1 if rng.random() < 0.5 else -1)
        return c

    for my in range(mbh):
        intra_left = [0] * 4
        nz_left = [0] * 9
        te = parts[my & (nparts - 1)]
        for mx in range(mbw):
            seg = 0
            if seg_probs is not None:
                seg = int(rng.integers(0, 4))
                e.put(seg_probs[0], seg >= 2)
                e.put(seg_probs[1 + (seg >> 1)], seg & 1)
            skip = 0
            if skip_prob is not None:
                skip = int(rng.random() < 0.3)
                e.put(skip_prob, skip)
            q = seg_q(seg)
            i4 = rng.random() < i4_share
            top = intra_top[mx]
            e.put(145, not i4)
            if i4:
                for y in range(4):
                    ym = intra_left[y]
                    for x in range(4):
                        prob = bmodes[top[x]][ym]
                        ym = int(rng.integers(0, 10))
                        path = {0: [(0, 0)], 1: [(0, 1), (1, 0)], 2: [(0, 1), (1, 1), (2, 0)],
                                3: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
                                4: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
                                5: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
                                6: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
                                7: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
                                8: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
                                9: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)]}[ym]
                        for i, b in path:
                            e.put(prob[i], b)
                        top[x] = ym
                    intra_left[y] = ym
            else:
                ym = int(rng.integers(0, 4))      # DC, TM, VE, HE
                e.put(156, ym in (1, 3))
                e.put(128 if ym in (1, 3) else 163, ym in (1, 2))
                top[:] = [ym] * 4
                intra_left[:] = [ym] * 4
            uvm = int(rng.integers(0, 4))
            e.put(142, uvm != 0)
            if uvm:
                e.put(114, uvm != 2)
                if uvm != 2:
                    e.put(183, uvm == 1)
            tnz, lnz = nz_top[mx], nz_left
            if skip:
                tnz[:8] = [0] * 8
                lnz[:8] = [0] * 8
                if not i4:
                    tnz[8] = lnz[8] = 0
                continue
            if not i4:
                f = int(_tokens(te, bands[1], tnz[8] + lnz[8], 0, levels(17, 0, 60)))
                tnz[8] = lnz[8] = f
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            for y in range(4):
                for x in range(4):
                    f = int(_tokens(te, ac, lnz[y] + tnz[x], first, levels(16, first, 255)))
                    tnz[x] = lnz[y] = f
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        f = int(_tokens(te, bands[2], lnz[ch + y] + tnz[ch + x], 0,
                                        levels(16, 0, 255)))
                        tnz[ch + x] = lnz[ch + y] = f
    first_part = e.finish()
    tokens = [p.finish() for p in parts]
    tag = (0 << 0) | (0 << 1) | (1 << 4) | (len(first_part) << 5)
    out = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", w, h) + first_part
    for t in tokens[:-1]:
        out += struct.pack("<I", len(t))[:3]
    return out + b"".join(tokens)



_VP8_CASES = {
    "normal filter": {},
    "simple filter": dict(simple=True),
    "simple filter, sharpness 5": dict(simple=True, sharpness=5, level=40),
    "sharpness 2": dict(sharpness=2, level=50),
    "sharpness 7, level 63": dict(sharpness=7, level=63),
    "filter deltas": dict(ref_delta=[5, -3, 0, 2], mode_delta=[-7, 0, 4, 1], level=30),
    "no filter": dict(level=0),
    "2 partitions": dict(parts_log2=1),
    "4 partitions": dict(parts_log2=2),
    "8 partitions": dict(parts_log2=3),
    "segments, absolute": dict(segments=(True, [5, 15, 25, 35], [0, 20, 40, 63],
                                         [120, 60, 200])),
    "segments, relative": dict(segments=(False, [-10, 0, 15, 30], [-20, 5, 10, 63],
                                         [30, 255, 90])),
    "segment data without a map": dict(segments=(False, [5, 0, 0, 0], [10, 0, 0, 0], None)),
    "skipped macroblocks": dict(skip_prob=100),
    "quantiser deltas": dict(dq=(3, -2, 5, -4, 2), base_q=5),
    "4x4 modes only": dict(i4_share=1.0),
    "16x16 modes only": dict(i4_share=0.0),
    "large coefficients": dict(big=True, base_q=0),
    "dense coefficients": dict(density=0.6, base_q=0),
}


@pytest.mark.parametrize("case", list(_VP8_CASES))
@pytest.mark.parametrize("shape", [(47, 33), (16, 16), (1, 1)], ids=str)
def test_hand_made_vp8_frames(case, shape):
    h, w = shape
    frame = vp8_frame(w, h, seed=list(_VP8_CASES).index(case), **_VP8_CASES[case])
    _same_as_pil(_riff([(b"VP8 ", frame)]))


# -- refusals ---------------------------------------------------------------------

@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("cut", [0.2, 0.6, 0.95])
def test_a_file_cut_short_raises(lossless, cut):
    data = _webp(_photo(40, 48, seed=9), lossless=lossless)
    data = data[:int(len(data) * cut)]
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="truncated|corrupt"):
        decode_webp(data)


def test_corrupt_and_refused_frames_raise():
    kind, payload = _bitstream(_webp(_photo(16, 16, seed=10)))
    inter = bytes([payload[0] | 1]) + payload[1:]               # not a key frame
    with pytest.raises(ValueError, match="not a key frame"):
        decode_webp(_riff([(b"VP8 ", inter)]))
    kind, payload = _bitstream(_webp(_photo(16, 16, seed=10), lossless=True))
    with pytest.raises(ValueError, match="VP8L"):
        decode_webp(_riff([(b"VP8L", b"\x2e" + payload[1:])]))  # bad signature
    with pytest.raises(ValueError):
        decode_webp(_riff([(b"VP8L", payload[:5] + b"\xff" * 20)]))
    with pytest.raises(ValueError):
        decode_webp(b"RIFF\x04\x00\x00\x00WEBP")
