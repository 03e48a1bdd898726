"""PCX, and DCX's first page, as PIL 12's PcxImagePlugin and
DcxImagePlugin read them, to their `convert("RGB")` pixels.

    rgb = decode_pcx(data)                    # (H, W, 3) uint8
    rgb = decode_dcx(data)                    # the first page

The 128-byte header: version (0, 2, 3 or 5), the window (x0, y0, x1, y1;
the size is x1 - x0 + 1 by y1 - y0 + 1), bits a plane, planes, bytes a
plane's line. PIL reads:

  - 1 bit, 1 plane: bilevel, a set bit white;
  - 1 bit, 2 or 4 planes: EGA indices (plane k is bit k) into the header's
    16-colour palette; PIL takes plane k at byte k * ceil(width / 8) of the
    line whatever the stride;
  - version 5, 8 bits, 1 plane: L, or P when the file ends in 0x0C and a
    256-colour palette that is not the grey ramp;
  - version 5, 8 bits, 3 planes: RGB, the planes one after another;

anything else is refused (PIL's OSError "unknown PCX mode"). A line holds
planes * stride bytes, where the stride is ceil(width * bits / 8), made
even where the header's bytes-a-line differs from it. The lines are
run-length coded (PcxDecode.c): a byte of the two top bits set repeats the
next byte (count in its low 6 bits), any other is itself; a run that
crosses a line's end is refused, as PIL refuses it. DCX: a table of page
offsets after its magic; the first page is a PCX (its 8-bit palette, as
PIL reads it, at the end of the whole file).
"""

from __future__ import annotations

import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, check_size

DCX_MAGIC = 0x3ADE68B1


def _rle_lines(data: bytes, pos: int, line: int, h: int) -> np.ndarray:
    """PcxDecode.c over the whole stream -> (h, line) uint8. A stream of
    twice the image's bytes (and a token) fills it unless it holds runs of
    count 0; only then is the rest of the body read."""
    need, avail = line * h, max(0, len(data) - pos)
    for n in sorted({min(avail, 2 * need + 2), avail}):
        out = _rle_tokens(np.frombuffer(data, np.uint8, count=n, offset=pos), line, need)
        if out is not None:
            return out.reshape(h, line)
    raise ValueError("PCX: truncated image data")


def _rle_tokens(src: np.ndarray, line: int, need: int):
    """Vectorised: a byte after a byte that is not a run header starts a
    token, and inside a stretch of run headers every other byte does.
    -> the first `need` bytes, or None if `src` does not fill them."""
    if not len(src):
        return None
    high = src >= 0xC0
    idx = np.arange(len(src))
    # offset of each byte in its stretch of run headers (0 outside one)
    starts = np.where(high & ~np.concatenate([[False], high[:-1]]), idx, 0)
    depth = idx - np.maximum.accumulate(starts)
    token = ~high | (depth % 2 == 0)                     # first byte of a token?
    token &= ~np.concatenate([[False], high[:-1] & token[:-1]])   # a run's value byte is not
    first = np.flatnonzero(token)
    run = high[first]
    complete = ~run | (first + 1 < len(src))
    first, run = first[complete], run[complete]
    count = np.where(run, src[first] & 0x3F, 1).astype(np.int64)
    value = src[np.where(run, first + 1, first)]
    end = np.cumsum(count)
    done = int(np.searchsorted(end, need))               # the token that fills the image
    if done >= len(end):
        return None
    count, value, end = count[:done + 1], value[:done + 1], end[:done + 1]
    crossed = run[:done + 1] & (count > 0) & ((end - count) // line != (end - 1) // line)
    if crossed.any():
        raise ValueError("PCX: a run crosses a line's end (PIL's buffer overrun)")
    return np.repeat(value, count)[:need]


def decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    s = data[start:start + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise NotThisFormat("PCX: not a PCX header")
    x0, y0, x1, y1 = struct.unpack("<HHHH", s[4:12])
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise NotThisFormat("PCX: bad image size")
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack("<H", s[66:68])
    if bits == 1 and planes in (1, 2, 4):
        mode = "1" if planes == 1 else "P"
    elif version == 5 and bits == 8 and planes in (1, 3):
        mode = "L" if planes == 1 else "RGB"
    else:
        raise ValueError(f"PCX: {planes} planes of {bits} bits (version {version}), "
                         f"PIL's unknown PCX mode")
    palette = None
    if mode == "P":
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif mode == "L":
        tail = data[-769:]                    # the file's end, a DCX's too
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != bytes(
                v for i in range(256) for v in (i, i, i)):
            mode, palette = "P", np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    check_size("PCX", w, h)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride
    rows = _rle_lines(data, start + 128, line, h)
    if line % w and line > w:                # PcxDecode.c packs each band to the width
        bands = line // w
        band_stride = line // bands
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * w:i * w + w] = rows[:, i * band_stride:i * band_stride + w].copy()
    if mode == "RGB":                        # RGB;L: the planes at 0, w and 2w
        return np.ascontiguousarray(np.stack([rows[:, 0:w], rows[:, w:2 * w],
                                              rows[:, 2 * w:3 * w]], -1))
    if bits == 8:
        px = rows[:, :w]
        return palette[px] if mode == "P" else np.repeat(px[..., None], 3, -1)
    plane = (w + 7) // 8                     # P;nL and "1": bit planes ceil(w / 8) apart
    idx = np.zeros((h, w), np.uint8)
    for k in range(planes):
        idx |= np.unpackbits(rows[:, k * plane:(k + 1) * plane], axis=1)[:, :w] << k
    return np.repeat((idx * np.uint8(255))[..., None], 3, -1) if mode == "1" else palette[idx]


def decode_dcx(data: bytes) -> np.ndarray:
    """DCX's first page. PIL reads the page table to its zero entry (at
    most 1024 pages); a table cut short, or empty, is not PIL's DCX."""
    pages = []
    for pos in range(4, 4 + 4 * 1024, 4):
        if len(data) < pos + 4:
            raise NotThisFormat("DCX: truncated page table")
        (offset,) = struct.unpack("<I", data[pos:pos + 4])
        if not offset:
            break
        pages.append(offset)
    if not pages:
        raise NotThisFormat("DCX: no pages")
    return decode_pcx(data, pages[0])
