"""Photoshop PSD as PIL 12's PsdImagePlugin reads it, to its
`convert("RGB")` pixels: the merged image, the frame `Image.open` gives.

    rgb = decode_psd(data)                    # (H, W, 3) uint8

The 26-byte header (version 1), the colour-mode data (a 768-byte planar
palette for indexed images), the image resources and the layer section
are skipped as PIL skips them; then the image data: compression 0 (raw
planes) or 1 (PackBits, after a table of each row's byte count). PIL
reads the (colour mode, depth) pairs of its MODES table, all at 8 bits
but bitmap's 1: bitmap (a set bit white, as PIL reads it), grey,
duotone and multichannel (the first channel), indexed (no 768-byte palette:
black), RGB (RGBA with a fourth channel, alpha dropped; further channels
ignored), CMYK (inverted, through PIL's cmyk2rgb) and Lab (through PIL's
LAB -> RGB, data/tiff.lab_to_rgb). Other depths are refused by name
(PIL does not open them). A PackBits packet that runs past a row's end
loses the bytes past it, as PIL's decoder drops them.
"""

from __future__ import annotations

import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, _bilevel, check_size

# (colour mode, bits) -> (PIL's mode, its channels)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


class _Reader:
    """A file position over the bytes, as PIL's reads see it: a read past
    the end is short; a field read short is NotThisFormat (PIL's
    struct.error)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(0, n)]
        self.pos += len(out)
        return out

    def uint(self, fmt: str) -> int:
        raw = self.read(struct.calcsize(fmt))
        if len(raw) < struct.calcsize(fmt):
            raise NotThisFormat("PSD: truncated header sections")
        return struct.unpack(fmt, raw)[0]


def _packbits(data: bytes, pos: int, row: int, h: int) -> np.ndarray:
    """PackDecode.c over one channel: a header byte n < 128 is a literal of
    n + 1 bytes, n > 128 a run of 257 - n, 128 nothing. A packet fills the
    current row and what it holds past the row's end is dropped."""
    out, need, n = bytearray(), row * h, len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("PSD: truncated PackBits data")
        c = data[pos]
        if c == 128:
            pos += 1
            continue
        count = c + 1 if c < 128 else 257 - c
        take = min(count, row - len(out) % row)
        if c < 128:
            if pos + 1 + count > n:
                raise ValueError("PSD: truncated PackBits data")
            out += data[pos + 1:pos + 1 + take]
            pos += 1 + count
        else:
            if pos + 2 > n:
                raise ValueError("PSD: truncated PackBits data")
            out += data[pos + 1:pos + 2] * take
            pos += 2
    return np.frombuffer(bytes(out), np.uint8).reshape(h, row)


def decode_psd(data: bytes) -> np.ndarray:
    from shmgan_tpu_torch.data.jpeg import _cmyk_to_rgb
    from shmgan_tpu_torch.data.tiff import lab_to_rgb

    if len(data) < 26 or struct.unpack(">H", data[4:6])[0] != 1:
        raise NotThisFormat("PSD: not a version-1 PSD header")
    channels, h, w, bits, colour = struct.unpack(">HIIHH", data[12:26])
    if (colour, bits) not in _MODES:
        raise ValueError(f"PSD: colour mode {colour} at {bits} bits, which PIL does not open")
    mode, nch = _MODES[colour, bits]
    if nch > channels:
        raise ValueError(f"PSD: {channels} channels, fewer than {mode} needs")
    if mode == "RGB" and channels == 4:
        mode, nch = "RGBA", 4
    f = _Reader(data, 26)
    size = f.uint(">I")
    colour_data = f.read(size)
    palette = np.zeros((256, 3), np.uint8)          # PIL's P with no palette is black
    if mode == "P" and size == 768:
        if len(colour_data) < 768:
            raise ValueError("PSD: truncated palette")
        palette = np.frombuffer(colour_data, np.uint8).reshape(3, 256).T
    size = f.uint(">I")                             # image resources
    end = f.pos + size
    while size and f.pos < end:
        f.read(4)
        f.uint(">H")
        name = f.read(f.uint(">B"))
        if not len(name) & 1:
            f.read(1)
        if len(f.read(f.uint(">I"))) & 1:
            f.read(1)
    size = f.uint(">I")                             # layer and mask information
    if size:
        end = f.pos + size
        f.uint(">I")
        f.pos = end
    compression = f.uint(">H")
    if w == 0 or h == 0:
        raise NotThisFormat("PSD: empty image")
    check_size("PSD", w, h)
    row = (w + 7) // 8 if mode == "1" else w
    if compression == 0:
        pos = f.pos
        if len(data) < pos + (nch - 1) * w * h + row * h:
            raise ValueError("PSD: truncated image data")
        planes = [np.frombuffer(data, np.uint8, count=row * h, offset=pos + c * w * h
                                ).reshape(h, row) for c in range(nch)]
    elif compression == 1:
        counts = f.read(2 * nch * h)
        if len(counts) < 2 * nch * h:
            raise NotThisFormat("PSD: truncated row byte counts")
        counts = np.frombuffer(counts, ">u2").astype(np.int64).reshape(nch, h).sum(1)
        starts = f.pos + np.concatenate([[0], np.cumsum(counts)[:-1]])
        planes = [_packbits(data, int(s), row, h) for s in starts]
    else:
        raise ValueError(f"PSD: compression {compression}, which PIL opens and cannot load")
    if mode == "1":
        return _bilevel(planes[0], w)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, -1)
    if mode == "P":
        return palette[planes[0]]
    if mode == "CMYK":                              # PIL's C;I, M;I, ...: inverted
        return _cmyk_to_rgb(planes, None)
    px = np.stack(planes[:3], -1)
    if mode == "LAB":                               # lab_to_rgb takes TIFF's signed a, b
        return lab_to_rgb(px ^ np.array([0, 128, 128], np.uint8))
    return px
