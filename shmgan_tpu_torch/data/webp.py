"""WebP decoding in numpy and the standard library: what the JAX package
gets from PIL's `Image.open(...).convert("RGB")`, which is libwebp's
WebPAnimDecoder (WebPImagePlugin opens every file through it), pixel for
pixel.

    rgb = decode_webp(data)     # (H, W, 3) uint8

The RIFF container: a plain `VP8 ` (lossy) or `VP8L` (lossless) file, or
`VP8X` with its ICCP, EXIF and XMP chunks skipped, an `ALPH` chunk skipped
(the RGB result does not depend on it: the decoder writes RGBA without
premultiplying, and `convert("RGB")` drops A), and, for an animation, the
first `ANMF` frame, put at its offset on a canvas of transparent black, as
WebPAnimDecoder puts a key frame (frame 1 always is one: no blending).

  - VP8L (RFC 9649), in full: prefix codes, simple and normal, meta prefix
    codes, LZ77 backward references with the 120-entry distance map, the
    colour cache, and the four transforms (predictor with its 14 modes,
    cross-colour, subtract green, colour indexing with pixel bundling);
  - VP8 key frames (RFC 6386), as libwebp decodes them: the boolean
    decoder, segmentation with quantiser and filter deltas, 1/2/4/8 token
    partitions, coefficient tokens with their probability updates, the WHT
    and libwebp's integer DCT, every 16x16, 4x4 and chroma intra mode with
    libwebp's 127/129 borders, the simple and normal loop filters with
    sharpness and mode/ref deltas in macroblock order, cropping to the
    frame; then libwebp's output path, the "fancy" upsampler
    (dsp/upsampling.c) and its 14-bit fixed-point YUV->RGB (dsp/yuv.h).

Entropy decoding (VP8L's prefix codes, VP8's boolean decoder) is a Python
loop a symbol over plain lists and buffers, as data/jpeg.py's scan decoder
is. Reconstruction is vectorised where the data allow: VP8L's predictor
along the anti-diagonals x + 2y of the image, the other transforms over
all pixels, VP8's DCT over all blocks at once, its loop filter along the
diagonals mx + 2my of the macroblock grid (every macroblock on one touches
pixels no other does, and depends only on earlier ones), upsampling and
colour over whole planes; VP8's intra prediction goes a macroblock at a
time (each reads its decoded neighbours).

Refused with a ValueError: a header that claims more pixels than PIL opens
(before anything is allocated), a VP8 frame that is not a key frame, and
input that is truncated or corrupt (libwebp refuses it too).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

# -- the container ------------------------------------------------------------------


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload end) of the RIFF chunks in [pos, end)."""
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise ValueError(f"WebP: truncated ({fourcc!r} chunk cut off)")
        yield fourcc, pos + 8, pos + 8 + size
        pos += 8 + size + (size & 1)


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB."""
    data = bytes(data)
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("WebP: no RIFF/WEBP header")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or 8 + riff > len(data):
        raise ValueError("WebP: truncated (RIFF size past the end of the file)")
    chunks = list(_chunks(data, 12, 8 + riff))
    if not chunks:
        raise ValueError("WebP: no chunks")
    kind, start, end = chunks[0]
    if kind in (b"VP8 ", b"VP8L"):
        return _frame(data, kind, start, end)
    if kind != b"VP8X":
        raise ValueError(f"WebP: unknown first chunk {kind!r}")
    if end - start < 10:
        raise ValueError("WebP: truncated VP8X chunk")
    flags = data[start]
    cw = 1 + int.from_bytes(data[start + 4:start + 7], "little")
    ch = 1 + int.from_bytes(data[start + 7:start + 10], "little")
    check_size("WebP", cw, ch)
    if flags & 0x02:                           # animation: the first frame
        for kind, s, e in chunks[1:]:
            if kind != b"ANMF":
                continue
            if e - s < 16:
                raise ValueError("WebP: truncated ANMF chunk")
            x0 = 2 * int.from_bytes(data[s:s + 3], "little")
            y0 = 2 * int.from_bytes(data[s + 3:s + 6], "little")
            fw = 1 + int.from_bytes(data[s + 6:s + 9], "little")
            fh = 1 + int.from_bytes(data[s + 9:s + 12], "little")
            if x0 + fw > cw or y0 + fh > ch:
                raise ValueError("WebP: animation frame outside the canvas")
            img = None
            for sub, ss, se in _chunks(data, s + 16, e):
                if sub in (b"VP8 ", b"VP8L"):
                    img = _frame(data, sub, ss, se)
                    break
            if img is None or img.shape[:2] != (fh, fw):
                raise ValueError("WebP: animation frame without a matching image")
            canvas = np.zeros((ch, cw, 3), np.uint8)
            canvas[y0:y0 + fh, x0:x0 + fw] = img
            return canvas
        raise ValueError("WebP: animation without frames")
    for kind, s, e in chunks[1:]:
        if kind in (b"VP8 ", b"VP8L"):
            img = _frame(data, kind, s, e)
            if img.shape[:2] != (ch, cw):
                raise ValueError("WebP: image size differs from the VP8X canvas")
            return img
    raise ValueError("WebP: no image chunk")


def _frame(data: bytes, kind: bytes, start: int, end: int) -> np.ndarray:
    """A VP8 or VP8L chunk's payload -> (h, w, 3) uint8 RGB."""
    if kind == b"VP8L":
        return _vp8l(data, start, end)
    return _vp8(data, start, end)


# -- VP8L ---------------------------------------------------------------------------

# the order in which code-length code lengths are stored
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# distance codes 1..120 -> (dy << 4) | (8 - dx) (RFC 9649 section 4.2.2)
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c03"
    "5759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f"
    "646c424e767a212f757b313f636d525e00747c414f1020626e30737d515f40727e616f50717f6070")


class _Bits:
    """VP8L's bit reader: least significant bit first, over 32-bit words,
    zeros past the end (an overrun is caught by `check`)."""

    def __init__(self, data: bytes, start: int, end: int):
        n = end - start
        self.words = np.frombuffer(data[start:end] + bytes((-n) % 4 + 8), "<u4").tolist()
        self.total = 8 * n
        self.wi, self.acc, self.nb = 0, 0, 0

    def read(self, n: int) -> int:
        if self.nb < n:
            self.acc |= self.words[self.wi] << self.nb
            self.wi += 1
            self.nb += 32
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nb -= n
        return v

    def used(self) -> int:
        return 32 * self.wi - self.nb

    def check(self) -> None:
        if self.used() > self.total:
            raise ValueError("WebP: truncated (VP8L data ends early)")


def _prefix_code(lengths: List[int]) -> Tuple[List[int], int]:
    """Canonical code lengths -> (lookup list over the next `bits` stream
    bits, bits); an entry is (length << 16) | symbol. One used symbol is a
    code of no bits, as libwebp builds it; none, an over-subscribed or an
    incomplete code is corrupt."""
    used = [(l, s) for s, l in enumerate(lengths) if l]
    if not used:
        raise ValueError("WebP: corrupt VP8L data (empty prefix code)")
    if len(used) == 1:
        return [used[0][1]], 0
    maxlen = max(l for l, _ in used)
    if sum(1 << (maxlen - l) for l, _ in used) != 1 << maxlen:
        raise ValueError("WebP: corrupt VP8L data (prefix code not complete)")
    table = np.zeros(1 << maxlen, np.int64)
    code = 0
    prev_len = 0
    for l, s in sorted(used):
        code <<= l - prev_len
        prev_len = l
        rev = int(f"{code:0{l}b}"[::-1], 2)
        table[rev::1 << l] = (l << 16) | s
        code += 1
    return table.tolist(), maxlen


def _read_symbol(br: _Bits, code) -> int:
    table, bits = code
    if not bits:
        return table[0]
    if br.nb < bits:
        br.acc |= br.words[br.wi] << br.nb
        br.wi += 1
        br.nb += 32
    e = table[br.acc & ((1 << bits) - 1)]
    n = e >> 16
    br.acc >>= n
    br.nb -= n
    return e & 0xFFFF


def _read_code(br: _Bits, alphabet: int):
    lengths = [0] * alphabet
    if br.read(1):                          # simple code: 1 or 2 symbols
        n = br.read(1) + 1
        symbols = [br.read(8 if br.read(1) else 1)]
        if n == 2:
            symbols.append(br.read(8))
        for s in symbols:
            if s < alphabet:
                lengths[s] = 1
        return _prefix_code(lengths)
    clen = [0] * 19
    for i in range(br.read(4) + 4):
        clen[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lc = _prefix_code(clen)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("WebP: corrupt VP8L data (code lengths past the alphabet)")
    else:
        max_symbol = alphabet
    prev, s = 8, 0
    while s < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = _read_symbol(br, lc)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.read(extra) + offset
            if s + repeat > alphabet:
                raise ValueError("WebP: corrupt VP8L data (code lengths past the alphabet)")
            value = prev if c == 16 else 0
            lengths[s:s + repeat] = [value] * repeat
            s += repeat
    return _prefix_code(lengths)


def _prefix_value(symbol: int, br: _Bits) -> int:
    """An LZ77 length or distance prefix symbol and its extra bits -> value."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: _Bits, w: int, h: int, top: bool) -> List[int]:
    """One entropy-coded image of w x h ARGB pixels (RFC 9649 section 5):
    the colour cache, the meta prefix codes (the main image only), then the
    pixels. Returns them as a flat list of ints."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("WebP: corrupt VP8L data (colour cache bits)")
    meta_bits, meta, mw = 0, None, 1
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        mw = -(-w // (1 << meta_bits))
        mh = -(-h // (1 << meta_bits))
        meta = [(p >> 8) & 0xFFFF for p in _entropy_image(br, mw, mh, False)]
    n_groups = max(meta) + 1 if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, 256 + 24 + cache_size), _read_code(br, 256),
                       _read_code(br, 256), _read_code(br, 256), _read_code(br, 40)])
        br.check()
    return _pixels(br, w, h, groups, meta, meta_bits, mw, cache_bits)


def _pixels(br: _Bits, w: int, h: int, groups, meta, meta_bits: int, mw: int,
            cache_bits: int) -> List[int]:
    """The LZ77-coded pixels: literals, backward references and colour-cache
    hits, a symbol at a time."""
    n = w * h
    out: List[int] = []
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0                              # pixels inserted into the cache so far
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    x = y = 0
    group = groups[0]
    words, wi, acc, nb = br.words, br.wi, br.acc, br.nb
    lookup = True
    try:
        while len(out) < n:
            if meta is not None and (lookup or not (x & mask)):
                group = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
                lookup = False
            green, red, blue, alpha, dist_code = group
            table, bits = green
            if bits:
                if nb < 32:
                    acc |= words[wi] << nb
                    wi += 1
                    nb += 32
                e = table[acc & ((1 << bits) - 1)]
                acc >>= e >> 16
                nb -= e >> 16
                code = e & 0xFFFF
            else:
                code = table[0]
            if code < 256:                  # a literal: red, blue, alpha follow
                argb = code << 8
                for k, c in ((16, red), (0, blue), (24, alpha)):
                    table, bits = c
                    if bits:
                        if nb < 32:
                            acc |= words[wi] << nb
                            wi += 1
                            nb += 32
                        e = table[acc & ((1 << bits) - 1)]
                        acc >>= e >> 16
                        nb -= e >> 16
                        argb |= (e & 0xFFFF) << k
                    else:
                        argb |= table[0] << k
                out.append(argb)
                x += 1
                if x == w:
                    x, y = 0, y + 1
            elif code < 256 + 24:           # a backward reference
                br.wi, br.acc, br.nb = wi, acc, nb
                length = _prefix_value(code - 256, br)
                dsym = _read_symbol(br, dist_code)
                dcode = _prefix_value(dsym, br)
                wi, acc, nb = br.wi, br.acc, br.nb
                if dcode > 120:
                    dist = dcode - 120
                else:
                    d = _CODE_TO_PLANE[dcode - 1]
                    dist = max(1, (d >> 4) * w + 8 - (d & 15))
                pos = len(out)
                if dist > pos or pos + length > n:
                    raise ValueError("WebP: corrupt VP8L data (backward reference)")
                if dist >= length:
                    out.extend(out[pos - dist:pos - dist + length])
                else:
                    for i in range(length):
                        out.append(out[pos - dist + i])
                x += length
                while x >= w:
                    x -= w
                    y += 1
                lookup = True
            elif cache is not None and code < 256 + 24 + len(cache):
                while cached < len(out):
                    p = out[cached]
                    cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                    cached += 1
                out.append(cache[code - 256 - 24])
                x += 1
                if x == w:
                    x, y = 0, y + 1
            else:
                raise ValueError("WebP: corrupt VP8L data (bad symbol)")
    except IndexError:
        raise ValueError("WebP: truncated (VP8L data ends early)") from None
    br.wi, br.acc, br.nb = wi, acc, nb
    br.check()
    return out


def _channels(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB (...,) -> (..., 4) int32 in A, R, G, B order."""
    a = argb.astype(np.int64)
    return np.stack([(a >> 24) & 255, (a >> 16) & 255, (a >> 8) & 255, a & 255], -1)


def _pack(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.uint32)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _inverse_predictor(res: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Undo the predictor transform on (h, w, 4) residuals, with (h, w)
    modes: the pixels of one anti-diagonal x + 2y = t at a time (each reads
    only L, T, TL and TR, all on earlier diagonals; TR of the last column is
    the first pixel of its own row, as the flat layout gives)."""
    h, w, _ = res.shape
    flat_res = res.reshape(-1, 4).astype(np.int64)
    out = np.zeros_like(flat_res)
    modes = modes.copy()
    modes[0, :] = 1                     # the first row predicts from L
    modes[:, 0] = 2                     # the first column from T
    modes[0, 0] = 0                     # the first pixel from black
    modes[modes > 13] = 0               # libwebp's padding: 14, 15 as 0
    ys_all, xs_all = np.mgrid[0:h, 0:w]
    t_all = (xs_all + 2 * ys_all).ravel()
    order = np.argsort(t_all, kind="stable")
    bounds = np.searchsorted(t_all[order], np.arange(t_all.max() + 2))
    flat_modes = modes.ravel()
    black = np.array([255, 0, 0, 0], np.int64)
    for t in range(len(bounds) - 1):
        idx = order[bounds[t]:bounds[t + 1]]
        if not len(idx):
            continue
        m = flat_modes[idx]
        L = out[np.maximum(idx - 1, 0)]
        T = out[np.maximum(idx - w, 0)]
        TL = out[np.maximum(idx - w - 1, 0)]
        TR = out[np.maximum(idx - w + 1, 0)]
        pred = np.empty((len(idx), 4), np.int64)
        for mode in np.unique(m).tolist():
            sel = m == mode
            l, tt, tl, tr = L[sel], T[sel], TL[sel], TR[sel]
            if mode == 0:
                p = np.broadcast_to(black, l.shape)
            elif mode == 1:
                p = l
            elif mode == 2:
                p = tt
            elif mode == 3:
                p = tr
            elif mode == 4:
                p = tl
            elif mode == 5:
                p = (((l + tr) >> 1) + tt) >> 1
            elif mode == 6:
                p = (l + tl) >> 1
            elif mode == 7:
                p = (l + tt) >> 1
            elif mode == 8:
                p = (tl + tt) >> 1
            elif mode == 9:
                p = (tt + tr) >> 1
            elif mode == 10:
                p = (((l + tl) >> 1) + ((tt + tr) >> 1)) >> 1
            elif mode == 11:
                d = (np.abs(l - tl).sum(-1) - np.abs(tt - tl).sum(-1))[:, None]
                p = np.where(d <= 0, tt, l)
            elif mode == 12:
                p = np.clip(l + tt - tl, 0, 255)
            else:
                a = (l + tt) >> 1
                d = a - tl
                p = np.clip(a + ((d + (d < 0)) >> 1), 0, 255)
            pred[sel] = p
        out[idx] = (flat_res[idx] + pred) & 255
    return out.reshape(h, w, 4)


def _vp8l(data: bytes, start: int, end: int) -> np.ndarray:
    """A VP8L bitstream -> (h, w, 3) uint8 RGB."""
    if end - start < 5 or data[start] != 0x2F:
        raise ValueError("WebP: corrupt VP8L header")
    br = _Bits(data, start + 1, end)
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)                              # alpha_is_used: a hint only
    if br.read(3) != 0:
        raise ValueError("WebP: unknown VP8L version")
    check_size("WebP", w, h)
    transforms, xsize, seen = [], w, set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("WebP: corrupt VP8L data (a transform used twice)")
        seen.add(kind)
        if kind in (0, 1):                  # predictor, cross-colour: a sub-image
            bits = br.read(3) + 2
            bw, bh = -(-xsize // (1 << bits)), -(-h // (1 << bits))
            sub = np.array(_entropy_image(br, bw, bh, False), np.uint32).reshape(bh, bw)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((kind, 0, None, xsize))
        else:                               # colour indexing
            ncolors = br.read(8) + 1
            bits = 0 if ncolors > 16 else 1 if ncolors > 4 else 2 if ncolors > 2 else 3
            pal = np.array(_entropy_image(br, ncolors, 1, False), np.uint32)
            pal = np.cumsum(_channels(pal), axis=0) & 255      # delta-coded, per channel
            transforms.append((kind, bits, _pack(pal), xsize))
            xsize = -(-xsize // (1 << bits))
    px = np.array(_entropy_image(br, xsize, h, True), np.uint32).reshape(h, xsize)
    for kind, bits, sub, tw in reversed(transforms):
        px = _undo_transform(kind, bits, sub, tw, px)
    return _channels(px)[..., 1:].astype(np.uint8)     # A dropped, as convert("RGB")


def _undo_transform(kind: int, bits: int, sub: np.ndarray, tw: int, px: np.ndarray
                    ) -> np.ndarray:
    """Undo one VP8L transform on (h, tw) uint32 ARGB: 0 predictor, 1
    cross-colour, 2 subtract green, 3 colour indexing (`sub`: the
    transform's sub-image, or the palette; `bits`: its block or bundling
    bits)."""
    h = px.shape[0]
    if kind == 0:
        modes = ((sub >> 8) & 15).astype(np.int64)
        ys, xs = np.arange(h) >> bits, np.arange(tw) >> bits
        return _pack(_inverse_predictor(_channels(px), modes[ys][:, xs]))
    if kind == 1:
        m = _channels(sub)[np.arange(h)[:, None] >> bits, np.arange(tw)[None] >> bits]
        g2r, g2b, r2b = (m[..., 3].astype(np.int8).astype(np.int64),
                         m[..., 2].astype(np.int8).astype(np.int64),
                         m[..., 1].astype(np.int8).astype(np.int64))
        c = _channels(px)
        green = c[..., 2].astype(np.int8).astype(np.int64)
        red = (c[..., 1] + ((g2r * green) >> 5)) & 255
        blue = c[..., 3] + ((g2b * green) >> 5)
        blue = (blue + ((r2b * red.astype(np.int8).astype(np.int64)) >> 5)) & 255
        c[..., 1], c[..., 3] = red, blue
        return _pack(c)
    if kind == 2:
        c = _channels(px)
        c[..., 1] = (c[..., 1] + c[..., 2]) & 255
        c[..., 3] = (c[..., 3] + c[..., 2]) & 255
        return _pack(c)
    full = np.zeros(256, np.uint32)        # indices past the palette: transparent black
    full[:len(sub)] = sub[:256]
    idx = ((px >> 8) & 255).astype(np.int64)
    if bits:
        xs = np.arange(tw)
        bpp = 8 >> bits
        idx = (idx[:, xs >> bits] >> ((xs & ((1 << bits) - 1)) * bpp)) & ((1 << bpp) - 1)
    return full[idx]


# -- VP8 ----------------------------------------------------------------------------

_COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
    63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83,
    84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114,
    116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84,
    86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125,
    128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249,
    254, 259, 264, 269, 274, 279, 284)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG_4 = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's intra modes: DC, TM, VE (V), HE (H), then the 4x4-only ones
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)
# number of left shifts that bring a range of 1..127 back to 128..255
_NORM = [0] + [7 - r.bit_length() + 1 for r in range(1, 128)]


class _Bool:
    """RFC 6386's boolean decoder (section 7), zeros past the end."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.end = data, end
        self.value = ((data[start] if start < end else 0) << 8) | (
            data[start + 1] if start + 1 < end else 0)
        self.pos, self.range, self.count = start + 2, 255, 0
        self.start = start

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        if self.range < 128:
            shift = _NORM[self.range]
            self.range <<= shift
            self.value <<= shift
            self.count += shift
            if self.count >= 8:
                self.count -= 8
                if self.pos < self.end:
                    self.value |= self.data[self.pos] << self.count
                self.pos += 1
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def flag_value(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0

    def overrun(self) -> bool:
        return 8 * (self.pos - self.start - 2) + self.count > 8 * (self.end - self.start)


def _coefficients(br: _Bool, bp, ctx: int, dq0: int, dq1: int, n: int, out, base: int) -> int:
    """libwebp's GetCoeffs: one 4x4 block's tokens from position n, each
    dequantised into out[base + raster index]. Returns the position past
    the last token read (16 after a run of zeros to the end)."""
    p = bp[n][ctx]
    data, end = br.data, br.end
    value, rng, count, pos = br.value, br.range, br.count, br.pos

    def bit(prob):
        nonlocal value, rng, count, pos
        split = 1 + (((rng - 1) * prob) >> 8)
        big = split << 8
        if value >= big:
            rng -= split
            value -= big
            b = 1
        else:
            rng = split
            b = 0
        if rng < 128:
            shift = _NORM[rng]
            rng <<= shift
            value <<= shift
            count += shift
            if count >= 8:
                count -= 8
                if pos < end:
                    value |= data[pos] << count
                pos += 1
        return b

    while n < 16:
        if not bit(p[0]):
            break                                   # end of block
        while not bit(p[1]):                        # a zero
            n += 1
            if n == 16:
                br.value, br.range, br.count, br.pos = value, rng, count, pos
                return 16
            p = bp[n][0]
        if not bit(p[2]):
            v = 1
            p = bp[n + 1][1]
        else:
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                v = 5 + bit(159) if not bit(p[7]) else 7 + 2 * bit(165) + bit(145)
            else:
                cat = 2 * bit(p[8])
                cat += bit(p[9 + cat // 2])
                v = 0
                for prob in _CAT_PROBS[cat]:
                    v += v + bit(prob)
                v += 3 + (8 << cat)
            p = bp[n + 1][2]
        out[base + _ZIGZAG_4[n]] = (-v if bit(128) else v) * (dq1 if n else dq0)
        n += 1
    br.value, br.range, br.count, br.pos = value, rng, count, pos
    return n


def _wht(dc: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT on (N, 16) int -> (N, 16) DC values of the 16
    luma blocks."""
    i = [dc[:, k] for k in range(16)]
    tmp = [None] * 16
    for c in range(4):
        a0, a1 = i[c] + i[12 + c], i[4 + c] + i[8 + c]
        a2, a3 = i[4 + c] - i[8 + c], i[c] - i[12 + c]
        tmp[c], tmp[8 + c], tmp[4 + c], tmp[12 + c] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [None] * 16
    for r in range(4):
        dc0 = tmp[4 * r] + 3
        a0, a1 = dc0 + tmp[4 * r + 3], tmp[4 * r + 1] + tmp[4 * r + 2]
        a2, a3 = tmp[4 * r + 1] - tmp[4 * r + 2], dc0 - tmp[4 * r + 3]
        out[4 * r], out[4 * r + 1] = (a0 + a1) >> 3, (a3 + a2) >> 3
        out[4 * r + 2], out[4 * r + 3] = (a0 - a1) >> 3, (a3 - a2) >> 3
    return np.stack(out, -1)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coefs: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne on (N, 16) int16 coefficients (raster order)
    -> (N, 4, 4) residuals, (v + 4) >> 3, to add to the prediction."""
    c = coefs.astype(np.int64).reshape(-1, 4, 4)
    t = []
    for col in range(4):
        i0, i1, i2, i3 = c[:, 0, col], c[:, 1, col], c[:, 2, col], c[:, 3, col]
        a, b = i0 + i2, i0 - i2
        cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
        t.append((a + d, b + cc, b - cc, a - d))
    rows = []
    for r in range(4):
        dc = t[0][r] + 4
        a, b = dc + t[2][r], dc - t[2][r]
        cc, d = _mul2(t[1][r]) - _mul1(t[3][r]), _mul1(t[1][r]) + _mul2(t[3][r])
        rows.append(np.stack([(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3, (a - d) >> 3], -1))
    return np.stack(rows, 1)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: List[int], left: List[int], tl: int) -> List[List[int]]:
    """libwebp's 4x4 intra predictors. top: the 8 pixels above (4 above, 4
    above-right), left: the 4 to the left, tl: above-left. Rows of 4."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == _DC:
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == _TM:
        return [[min(255, max(0, top[x] + left[y] - X)) for x in range(4)] for y in range(4)]
    if mode == _VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == _HE:
        return [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4, [_avg3(J, K, L)] * 4,
                [_avg3(K, L, L)] * 4]
    d = [[0] * 4 for _ in range(4)]             # d[y][x]

    def put(v, *xy):
        for x, y in xy:
            d[y][x] = v
    if mode == _RD:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == _LD:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == _VR:
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == _VL:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == _HU:
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    else:                                       # _HD
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(X, I, J), (1, 1), (3, 2))
        put(_avg3(I, J, K), (1, 2), (3, 3))
        put(_avg3(J, K, L), (1, 3))
    return d


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int,
                has_top: bool, has_left: bool) -> np.ndarray:
    """libwebp's 16x16 luma and 8x8 chroma predictors (DC's variants for
    the frame's top and left edges, CheckMode)."""
    if mode == _DC:
        shift = size.bit_length() - 1           # 4 for 16, 3 for 8
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            v = (int(left.sum()) + size // 2) >> shift
        elif has_top:
            v = (int(top.sum()) + size // 2) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == _TM:
        return np.clip(top[None, :].astype(np.int64) + left[:, None] - tl, 0, 255)
    if mode == _VE:
        return np.broadcast_to(top[None, :].astype(np.int64), (size, size))
    return np.broadcast_to(left[:, None].astype(np.int64), (size, size))


def _vp8(data: bytes, start: int, end: int) -> np.ndarray:
    """A VP8 key frame -> (h, w, 3) uint8 RGB."""
    if end - start < 10:
        raise ValueError("WebP: truncated VP8 header")
    bits = data[start] | (data[start + 1] << 8) | (data[start + 2] << 16)
    if bits & 1:
        raise ValueError("WebP: a VP8 frame that is not a key frame")
    if ((bits >> 1) & 7) > 3:
        raise ValueError("WebP: unknown VP8 profile")
    if not (bits >> 4) & 1:
        raise ValueError("WebP: a VP8 frame that is not shown")
    part0 = bits >> 5
    if data[start + 3:start + 6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: corrupt VP8 start code")
    w = (data[start + 6] | (data[start + 7] << 8)) & 0x3FFF
    h = (data[start + 8] | (data[start + 9] << 8)) & 0x3FFF
    if not w or not h:
        raise ValueError("WebP: empty VP8 frame")
    check_size("WebP", w, h)
    p0 = start + 10
    if p0 + part0 > end:
        raise ValueError("WebP: truncated (first VP8 partition cut off)")
    br = _Bool(data, p0, p0 + part0)
    br.bit(128)                                 # colour space
    br.bit(128)                                 # clamping type
    # segment header
    use_segment = br.bit(128)
    update_map = False
    seg_quant, seg_filter, absolute = [0] * 4, [0] * 4, True   # libwebp's defaults
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = br.bit(128)
        if br.bit(128):                         # update data
            absolute = br.bit(128)
            seg_quant = [br.flag_value(7) for _ in range(4)]
            seg_filter = [br.flag_value(6) for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    # filter header
    simple = br.bit(128)
    level = br.literal(6)
    sharpness = br.literal(3)
    use_lf_delta = br.bit(128)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and br.bit(128):
        ref_delta = [br.flag_value(6) for _ in range(4)]
        mode_delta = [br.flag_value(6) for _ in range(4)]
    filter_type = 0 if level == 0 else 1 if simple else 2
    # partitions
    last = (1 << br.literal(2)) - 1
    buf = p0 + part0
    if end - buf < 3 * last:
        raise ValueError("WebP: truncated (VP8 partition sizes cut off)")
    parts, ps, left = [], buf + 3 * last, end - buf - 3 * last
    for p in range(last):
        size = min(left, data[buf + 3 * p] | (data[buf + 3 * p + 1] << 8)
                   | (data[buf + 3 * p + 2] << 16))
        parts.append(_Bool(data, ps, ps + size))
        ps += size
        left -= size
    if ps >= end:
        raise ValueError("WebP: truncated (VP8 token partitions cut off)")
    parts.append(_Bool(data, ps, end))
    # quantisers
    base_q = br.literal(7)
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = (br.flag_value(4) for _ in range(5))
    quant = []
    for s in range(4):
        q = (seg_quant[s] if absolute else seg_quant[s] + base_q) if use_segment else base_q
        clip = lambda v, m: min(max(v, 0), m)   # noqa: E731
        y1 = (_DC_TABLE[clip(q + dqy1_dc, 127)], _AC_TABLE[clip(q, 127)])
        y2 = (_DC_TABLE[clip(q + dqy2_dc, 127)] * 2,
              max(8, _AC_TABLE[clip(q + dqy2_ac, 127)] * 101581 >> 16))
        uv = (_DC_TABLE[clip(q + dquv_dc, 117)], _AC_TABLE[clip(q + dquv_ac, 127)])
        quant.append((y1, y2, uv))
    br.bit(128)                                 # refresh entropy probabilities: ignored
    proba = np.frombuffer(_COEFFS_PROBA0, np.uint8).reshape(4, 8, 3, 11).astype(np.int64)
    update = np.frombuffer(_COEFFS_UPDATE_PROBA, np.uint8).reshape(4, 8, 3, 11).tolist()
    proba = proba.tolist()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(update[t][b][c][p]):
                        proba[t][b][c][p] = br.literal(8)
    bands = [[proba[t][_BANDS[n]] for n in range(17)] for t in range(4)]
    use_skip = br.bit(128)
    skip_prob = br.literal(8) if use_skip else 0
    if br.overrun():
        raise ValueError("WebP: truncated (VP8 frame header)")
    # filter strengths: (limit, interior limit, hev threshold) by segment and i4x4
    strengths = []
    for s in range(4):
        base_level = level
        if use_segment:
            base_level = seg_filter[s] + (0 if absolute else level)
        row = []
        for i4 in (0, 1):
            lv = base_level
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                row.append((2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                row.append((0, 0, 0))
        strengths.append(row)

    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    n_mb = mbw * mbh
    coefs = np.zeros(n_mb * 384, np.int32)      # 16 Y, 4 U, 4 V blocks of 16
    coef_list = [0] * 384
    y2 = np.zeros((n_mb, 16), np.int32)
    is_i4 = np.zeros(n_mb, bool)
    ymodes = np.zeros((n_mb, 16), np.int64)
    uvmodes = np.zeros(n_mb, np.int64)
    nonzero = np.zeros(n_mb, bool)              # a token was coded (before the WHT)
    parsed = np.zeros(n_mb, bool)               # residuals read (not skipped)
    segment = np.zeros(n_mb, np.int64)
    bmodes = np.frombuffer(_BMODES_PROBA, np.uint8).reshape(10, 10, 9).tolist()
    intra_top = [[_DC] * 4 for _ in range(mbw)]
    nz_top = [[0] * 9 for _ in range(mbw)]      # 4 Y, 2 U, 2 V, Y2
    for my in range(mbh):
        intra_left = [_DC] * 4
        nz_left = [0] * 9
        tb = parts[my & last]
        for mx in range(mbw):
            m = my * mbw + mx
            seg = 0
            if update_map:
                seg = br.bit(seg_probs[1]) if not br.bit(seg_probs[0]) else 2 + br.bit(seg_probs[2])
            segment[m] = seg
            skip = br.bit(skip_prob) if use_skip else 0
            top = intra_top[mx]
            if not br.bit(145):                 # 4x4 modes
                is_i4[m] = True
                for y in range(4):
                    ym = intra_left[y]
                    for x in range(4):
                        prob = bmodes[top[x]][ym]
                        if not br.bit(prob[0]):
                            ym = _DC
                        elif not br.bit(prob[1]):
                            ym = _TM
                        elif not br.bit(prob[2]):
                            ym = _VE
                        elif not br.bit(prob[3]):
                            ym = _HE if not br.bit(prob[4]) else (
                                _RD if not br.bit(prob[5]) else _VR)
                        elif not br.bit(prob[6]):
                            ym = _LD
                        elif not br.bit(prob[7]):
                            ym = _VL
                        else:
                            ym = _HD if not br.bit(prob[8]) else _HU
                        ymodes[m, 4 * y + x] = ym
                        top[x] = ym
                    intra_left[y] = ym
            else:
                ym = (_TM if br.bit(128) else _HE) if br.bit(156) else (
                    _VE if br.bit(163) else _DC)
                ymodes[m, 0] = ym
                top[:] = [ym] * 4
                intra_left[:] = [ym] * 4
            uvmodes[m] = _DC if not br.bit(142) else _VE if not br.bit(114) else (
                _TM if br.bit(183) else _HE)
            tnz, lnz = nz_top[mx], nz_left
            if skip:
                tnz[:8] = [0] * 8
                lnz[:8] = [0] * 8
                if not is_i4[m]:
                    tnz[8] = lnz[8] = 0
                continue
            parsed[m] = True
            (dq_y1, dq_y2, dq_uv) = quant[segment[m]]
            out = coef_list
            out[:] = [0] * 384
            any_nz = False
            if not is_i4[m]:
                dc = [0] * 16
                nz = _coefficients(tb, bands[1], tnz[8] + lnz[8], dq_y2[0], dq_y2[1], 0, dc, 0)
                tnz[8] = lnz[8] = int(nz > 0)
                y2[m] = dc
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            for y in range(4):
                for x in range(4):
                    nz = _coefficients(tb, ac, lnz[y] + tnz[x], dq_y1[0], dq_y1[1], first,
                                       out, 16 * (4 * y + x))
                    flag = int(nz > first)
                    tnz[x] = lnz[y] = flag
                    any_nz = any_nz or nz > first
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = _coefficients(tb, bands[2], lnz[ch + y] + tnz[ch + x], dq_uv[0],
                                           dq_uv[1], 0, out, 16 * (16 + 2 * (ch - 4) + 2 * y + x))
                        tnz[ch + x] = lnz[ch + y] = int(nz > 0)
                        any_nz = any_nz or nz > 0
            nonzero[m] = any_nz
            coefs[384 * m:384 * (m + 1)] = out
            if tb.overrun():
                raise ValueError("WebP: truncated (VP8 token partition ends early)")
    if br.overrun():
        raise ValueError("WebP: truncated (first VP8 partition ends early)")

    blocks = coefs.reshape(n_mb, 24, 16).astype(np.int16)
    i16 = ~is_i4
    if i16.any():
        dcs = _wht(y2[i16].astype(np.int16).astype(np.int64)).astype(np.int16)
        sub = blocks[i16]
        sub[:, :16, 0] = dcs
        blocks[i16] = sub
        nonzero[i16] |= (dcs != 0).any(-1)
    res = _idct(blocks.reshape(-1, 16)).reshape(n_mb, 24, 4, 4)
    inner = is_i4 | (parsed & nonzero)
    yp, up, vp = _reconstruct(mbw, mbh, is_i4, ymodes, uvmodes, res)
    if filter_type:
        params = np.array([strengths[s][int(i4)] for s, i4 in zip(segment.tolist(),
                                                                    is_i4.tolist())])
        _loop_filter(yp, up, vp, mbw, mbh, params, inner, filter_type == 1)
    return _yuv_to_rgb(yp[:h, :w], up[:(h + 1) // 2, :(w + 1) // 2],
                       vp[:(h + 1) // 2, :(w + 1) // 2])


def _reconstruct(mbw: int, mbh: int, is_i4, ymodes, uvmodes, res):
    """Intra prediction plus residuals, a macroblock at a time in raster
    order, with libwebp's borders: 127 above the frame (above-left and
    above-right too), 129 left of it, the above-left of a row's first
    macroblock 129 below the first row; a 4x4 block's above-right past the
    macroblock's right edge is the macroblock above-right's bottom row (its
    own last pixel on the last column), for every row of blocks. Returns
    the unfiltered Y, U, V planes of the whole macroblock grid."""
    Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
    U = np.zeros((8 * mbh, 8 * mbw), np.int64)
    V = np.zeros((8 * mbh, 8 * mbw), np.int64)
    res = res.astype(np.int64)
    luma_res = res[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
    u_res = res[:, 16:20].reshape(-1, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
    v_res = res[:, 20:24].reshape(-1, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
    is_i4, ymodes, uvmodes = is_i4.tolist(), ymodes.tolist(), uvmodes.tolist()
    for my in range(mbh):
        for mx in range(mbw):
            m = my * mbw + mx
            y0, x0 = 16 * my, 16 * mx
            ws = np.zeros((17, 21), np.int64)
            if my:
                ws[0, 1:17] = Y[y0 - 1, x0:x0 + 16]
                ws[0, 0] = Y[y0 - 1, x0 - 1] if mx else 129
                ws[0, 17:21] = Y[y0 - 1, x0 + 16:x0 + 20] if mx < mbw - 1 else Y[y0 - 1, x0 + 15]
            else:
                ws[0, :] = 127
            ws[1:, 0] = Y[y0:y0 + 16, x0 - 1] if mx else 129
            if is_i4[m]:
                ws[4, 17:21] = ws[8, 17:21] = ws[12, 17:21] = ws[0, 17:21]
                wl = ws.tolist()
                r = luma_res[m]
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    row = wl[4 * by]
                    top = row[1 + 4 * bx:9 + 4 * bx]
                    left = [wl[1 + 4 * by + i][4 * bx] for i in range(4)]
                    pred = _pred4(ymodes[m][n], top, left, row[4 * bx])
                    for i in range(4):
                        dst = wl[1 + 4 * by + i]
                        rr = r[4 * by + i]
                        for j in range(4):
                            v = pred[i][j] + int(rr[4 * bx + j])
                            dst[1 + 4 * bx + j] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.asarray(wl, np.int64)[1:, 1:17]
            else:
                pred = _pred_block(ymodes[m][0], ws[0, 1:17], ws[1:, 0], int(ws[0, 0]), 16,
                                   my > 0, mx > 0)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + luma_res[m], 0, 255)
            c0, d0 = 8 * my, 8 * mx
            for P, R in ((U, u_res), (V, v_res)):
                if my:
                    top = P[c0 - 1, d0:d0 + 8]
                    tl = int(P[c0 - 1, d0 - 1]) if mx else 129
                else:
                    top, tl = np.full(8, 127, np.int64), 127
                left = P[c0:c0 + 8, d0 - 1] if mx else np.full(8, 129, np.int64)
                pred = _pred_block(uvmodes[m], top, left, tl, 8, my > 0, mx > 0)
                P[c0:c0 + 8, d0:d0 + 8] = np.clip(pred + R[m], 0, 255)
    return Y, U, V


def _edge_filter(W: np.ndarray, kind: str, t2, it, hev_t) -> np.ndarray:
    """libwebp's loop filters on (n, lines, 8) windows across one edge (taps
    p3 p2 p1 p0 | q0 q1 q2 q3), thresholds (n, 1): "simple" (DoFilter2 where
    NeedsFilter), "mb" (FilterLoop26: DoFilter2 on high edge variance, else
    DoFilter6) and "inner" (FilterLoop24: DoFilter2, else DoFilter4)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (W[..., i] for i in range(8))
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= it
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    out = W.copy()
    sclip1 = lambda v: np.clip(v, -128, 127)    # noqa: E731
    clip1 = lambda v: np.clip(v, 0, 255)        # noqa: E731
    f2 = mask & hev
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    out[..., 3] = np.where(f2, clip1(p0 + a2), out[..., 3])
    out[..., 4] = np.where(f2, clip1(q0 - a1), out[..., 4])
    if kind == "simple":
        return out
    rest = mask & ~hev
    if kind == "mb":
        a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for i, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                     (6, q2 - a3)):
            out[..., i] = np.where(rest, clip1(v), out[..., i])
    else:
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for i, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            out[..., i] = np.where(rest, clip1(v), out[..., i])
    return out


def _filter_at(plane, oy, ox, size: int, k: int, across_columns: bool, kind: str,
               t2, it, hev_t) -> None:
    """Filter the edge at offset k of the size x size blocks at (oy, ox)."""
    lines, taps = np.arange(size), np.arange(-4, 4) + k
    if across_columns:                  # a vertical edge: taps along a row
        r = (oy[:, None] + lines)[:, :, None]
        c = (ox[:, None] + taps)[:, None, :]
    else:                               # a horizontal edge: taps down a column
        r = (oy[:, None] + taps)[:, None, :]
        c = (ox[:, None] + lines)[:, :, None]
    plane[r, c] = _edge_filter(plane[r, c], kind, t2, it, hev_t)


def _loop_filter(Y, U, V, mbw: int, mbh: int, params, inner, simple: bool) -> None:
    """libwebp's DoFilter for every macroblock, in place: left edge, inner
    vertical edges, top edge, inner horizontal edges. Macroblocks go by the
    diagonals t = mx + 2my: one reads and writes at most 4 pixels into its
    left and upper neighbours, so those on one diagonal touch disjoint
    pixels, and every macroblock it overlaps comes before it in raster
    order exactly when it lies on an earlier diagonal."""
    limit, ilevel, hev_t = params[:, 0], params[:, 1], params[:, 2]
    mys, mxs = np.divmod(np.arange(mbw * mbh), mbw)
    diag = mxs + 2 * mys
    for t in range(int(diag.max()) + 1):
        ms = np.flatnonzero((diag == t) & (limit > 0))
        if not len(ms):
            continue
        my, mx = mys[ms], mxs[ms]
        lim, il, hv = limit[ms][:, None], ilevel[ms][:, None], hev_t[ms][:, None]
        inn = inner[ms]
        for across in (True, False):
            edge = mx > 0 if across else my > 0
            if edge.any():
                e = edge
                args = (2 * (lim[e] + 4) + 1, il[e], hv[e])
                _filter_at(Y, 16 * my[e], 16 * mx[e], 16, 0, across,
                           "simple" if simple else "mb", *args)
                if not simple:
                    for P in (U, V):
                        _filter_at(P, 8 * my[e], 8 * mx[e], 8, 0, across, "mb", *args)
            if inn.any():
                e = inn
                args = (2 * lim[e] + 1, il[e], hv[e])
                for k in (4, 8, 12):
                    _filter_at(Y, 16 * my[e], 16 * mx[e], 16, k, across,
                               "simple" if simple else "inner", *args)
                if not simple:
                    for P in (U, V):
                        _filter_at(P, 8 * my[e], 8 * mx[e], 8, 4, across, "inner", *args)


def _upsample(C: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler (UpsampleRgbaLinePair over EmitFancyRGB's
    row pairs): output row y has a near chroma row and a far one (row 0:
    row 0 twice; 2k - 1: k - 1 near, k far, or k - 1 twice past the last
    row; 2k: k near, k - 1 far), and each output pixel mixes the two nearest
    chroma columns of both rows in its two-step rounding."""
    ch, cw = C.shape
    y = np.arange(h)
    k = (y + 1) >> 1
    near = np.where(y == 0, 0, np.where(y & 1, k - 1, k))
    far = np.where(y == 0, 0, np.where(y & 1, np.minimum(k, ch - 1), k - 1))
    N, F = C[near].astype(np.int64), C[far].astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        nl, nr, fl, fr = N[:, :pairs], N[:, 1:pairs + 1], F[:, :pairs], F[:, 1:pairs + 1]
        out[:, 1:2 * pairs:2] = (((nl + 3 * nr + 3 * fl + fr + 8) >> 3) + nl) >> 1
        out[:, 2:2 * pairs + 1:2] = (((3 * nl + nr + fl + 3 * fr + 8) >> 3) + nr) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * N[:, pairs] + F[:, pairs] + 2) >> 2
    return out


def _yuv_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Fancy upsampling, then dsp/yuv.h's 14-bit fixed-point BT.601."""
    h, w = Y.shape
    u, v, y = _upsample(U, h, w), _upsample(V, h, w), Y.astype(np.int64)

    def clip8(x):
        return np.where((x & ~((256 << 6) - 1)) == 0, x >> 6, np.where(x < 0, 0, 255))
    yy = (y * 19077) >> 8
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
