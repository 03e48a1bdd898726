"""Windows icons and cursors (ICO, CUR) and Apple icons (ICNS) as PIL 12's
IcoImagePlugin, CurImagePlugin and IcnsImagePlugin read them, to their
`convert("RGB")` pixels: the entry PIL picks, alpha dropped.

    rgb = decode_ico(data); decode_cur(data); decode_icns(data)

ICO: a directory of 16-byte entries (width and height, 0 meaning 256,
colour count, planes, bits, size, offset); IcoFile sorts them by area,
largest first, the fewest bits (or log2 of the colours) first among
equals, and loads the first. An entry is a PNG (the port's PNG decoder)
or a headerless DIB of twice the height (the XOR bitmap, then the AND
mask: PIL refuses an entry whose mask, or 32-bit alpha, the file cuts
short). CUR: an ICO of type 2; PIL picks the first entry unless a later
one is larger in both its width and height bytes, reads it as a DIB and
halves its height, with no mask; a CUR whose directory is empty, as in a
type-2 TGA with no footer (`00 00 02 00 00 00`), is not PIL's CUR.
ICNS: 8-byte block headers; the largest size present (IcnsFile.SIZES) is
loaded: a PNG or JPEG 2000 entry (ic07-ic14, icp4-icp6), or 24-bit
`is32`/`il32`/`ih32`/`it32` data, raw or in Apple's run-length code,
with its `s8mk`/`l8mk`/`h8mk`/`t8mk` mask, which PIL reads and drops.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import PNG_SIGNATURE, NotThisFormat, dib

# -- ICO, CUR ----------------------------------------------------------------------


def _png_entry(data: bytes, offset: int, kind: str) -> np.ndarray:
    from shmgan_tpu_torch.data.codecs import _decode_png

    try:
        return _decode_png(data[offset:])
    except NotThisFormat:
        raise
    except ValueError as e:
        raise ValueError(f"{kind}: PNG entry: {e}") from None


def decode_ico(data: bytes) -> np.ndarray:
    if len(data) < 6:
        raise NotThisFormat("ICO: truncated header")
    (count,) = struct.unpack("<H", data[4:6])
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:6 + 16 * (i + 1)]
        if len(s) < 16:
            raise NotThisFormat("ICO: truncated directory")
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack("<HII", s[6:16])
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((w * h, depth, (w, h), bpp, size, offset))
    if not entries:
        raise NotThisFormat("ICO: no entries")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, (w, h), bpp, size, offset = entries[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return _png_entry(data, offset, "ICO")
    rgb, raster = dib(data, offset, 0, "ICO", halve=True)
    h, w = rgb.shape[:2]
    if bpp == 32:                       # PIL reads the alpha bytes beside the pixels
        if len(data) - raster < 4 * w * h - 3:
            raise ValueError("ICO: the 32-bit entry's alpha is cut short")
    else:                               # and the AND mask at the entry's end, whose
        stride = (w + 31) // 32 * 4     # last row's padding PIL's raw decoder never reads
        mask = offset + size - stride * h
        if mask < 0 or len(data) - mask < stride * (h - 1) + (w + 7) // 8:
            raise ValueError("ICO: the entry's AND mask is cut short")
    return rgb


def decode_cur(data: bytes) -> np.ndarray:
    if len(data) < 6:
        raise NotThisFormat("CUR: truncated header")
    (count,) = struct.unpack("<H", data[4:6])
    best = b""
    for i in range(count):
        s = data[6 + 16 * i:6 + 16 * (i + 1)]
        if not best:
            best = s
        elif len(s) < 2:
            raise NotThisFormat("CUR: truncated directory")
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best:
        raise NotThisFormat("CUR: no cursors")       # PIL's TypeError: the next plugin
    if len(best) < 16:
        raise NotThisFormat("CUR: truncated directory")
    (offset,) = struct.unpack("<I", best[12:16])
    # _bitmap(header) seeks only to a nonzero offset: 0 reads on after the directory
    start = offset or min(len(data), 6 + 16 * count)
    return dib(data, start, 0, "CUR", halve=True)[0]


# -- ICNS --------------------------------------------------------------------------

# IcnsFile.SIZES: (width, height, scale) -> its block types, in its order
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_JP2_STARTS = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def _icns_rgb(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """read_32: 24-bit RGB, raw if the block is exactly 3 * side^2 bytes,
    else three planes in Apple's run-length code (a byte b >= 128 repeats
    the next byte b - 125 times, any other is b + 1 literal bytes), each
    filling its plane exactly."""
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < 3 * n:
            raise ValueError("ICNS: truncated RGB entry")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3)
    planes, pos = [], start
    for band in range(3):
        out, left = bytearray(), n
        while left > 0:
            if pos >= len(data):
                break
            c = data[pos]
            pos += 1
            if c & 0x80:
                count = c - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = c + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"ICNS: RLE channel {band} does not fill its plane ({left} left)")
        if len(out) < n:
            raise ValueError(f"ICNS: RLE channel {band} is cut short")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8).reshape(side, side))
    return np.stack(planes, -1)


def _icns_entry(data: bytes, start: int, length: int) -> np.ndarray:
    """read_png_or_jpeg2000: a PNG (read on from its start) or a JPEG 2000
    codestream or JP2 file of `length` bytes."""
    from shmgan_tpu_torch.data.jpeg2000 import decode_jpeg2000

    sig = data[start:start + 12]
    if sig.startswith(PNG_SIGNATURE):
        return _png_entry(data, start, "ICNS")
    if sig.startswith(_JP2_STARTS) or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        return decode_jpeg2000(data[start:start + max(0, length)])
    raise ValueError("ICNS: unsupported icon subimage format")


def decode_icns(data: bytes) -> np.ndarray:
    if len(data) < 8:
        raise NotThisFormat("ICNS: truncated header")
    (filesize,) = struct.unpack(">I", data[4:8])
    blocks, pos = {}, 8
    while pos < filesize:               # a block's data after its 8-byte header
        if len(data) < pos + 8:
            raise NotThisFormat("ICNS: truncated block header")
        sig, size = struct.unpack(">4sI", data[pos:pos + 8])
        if size <= 0:
            raise NotThisFormat("ICNS: invalid block header")
        blocks[sig] = (pos + 8, size - 8)
        pos += size
    sizes = [s for s, kinds in _ICNS_SIZES.items() if any(k in blocks for k in kinds)]
    if not sizes:
        raise NotThisFormat("ICNS: no 32-bit icon resources")
    best = max(sizes)
    side = best[0] * best[2]
    channels = {}
    for kind in _ICNS_SIZES[best]:                  # every reader runs, as in dataforsize
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        if kind.endswith(b"mk"):
            if len(data) - start < side * side:
                raise ValueError("ICNS: truncated mask")
            channels["A"] = True
        elif kind.endswith(b"32"):
            if kind == b"it32":
                if data[start:start + 4] != b"\x00\x00\x00\x00":
                    raise ValueError("ICNS: it32 without its zero signature")
                start, length = start + 4, length - 4
            channels["RGB"] = _icns_rgb(data, start, length, side)
        else:
            channels["RGBA"] = _icns_entry(data, start, length)
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError("ICNS: a mask with no RGB entry")
    return np.ascontiguousarray(channels["RGB"])
