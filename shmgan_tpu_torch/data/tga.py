"""Truevision TGA as PIL 12's TgaImagePlugin reads it, to its
`convert("RGB")` pixels.

    rgb = decode_tga(data)                    # (H, W, 3) uint8

TGA has no signature (its footer is optional), so `Image.open` tries it on
whatever no earlier plugin took, and so does `codecs.decode`. A header is
TGA's if its colour-map type is 0 or 1, its size is not empty, its depth is
1, 8, 16, 24 or 32 and its image type is 1, 2, 3, 9, 10 or 11; otherwise
NotThisFormat, as PIL's SyntaxError. PIL then reads:

  - types 3 and 11 (grey): 1 bit (mode "1"), 8 bits (L), 16 bits (LA);
  - types 1 and 9 (colour-mapped): 8-bit indices into a colour map of
    16-bit (BGRA;15Z), 24-bit (BGR) entries, `first index` zero entries
    before them; a type 1 or 9 without a colour map opens as L and does
    not load;
  - types 2 and 10 (true colour): 16 bits (BGRA;15Z: 5 bits a channel,
    v * 255 // 31, the attribute bit dropped), 24 (BGR), 32 (BGRA);
  - types 9, 10 and 11 run-length coded (TgaRleDecode.c): a literal packet
    may run on into the next row, a run packet that crosses a row's end
    is an overrun PIL refuses;
  - rows bottom-up unless the descriptor's bit 5 is set, mirrored if bit 4
    is; the ID field skipped; alpha dropped, never composited.

Every other type/depth pairing PIL opens and cannot load (a colour map
beside true-colour or grey pixels, more than 256 map entries, a 32-bit
map, run-length 1-bit pixels), and the port refuses it, as it refuses a
truncated body.
"""

from __future__ import annotations

import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, _bilevel, check_size

# (image type & 7, depth) -> PIL's raw mode, its MODES table
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
             (2, 24): "BGR", (2, 32): "BGRA"}


def _bgr15(px: np.ndarray) -> np.ndarray:
    """(..., 2) little-endian 16-bit pixels -> (..., 3) RGB, as PIL's
    BGRA;15Z unpacker: 5 bits a channel, v * 255 // 31."""
    v = px[..., 0].astype(np.int64) | (px[..., 1].astype(np.int64) << 8)
    return (np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1) * 255 // 31).astype(np.uint8)


def _rle(data: bytes, pos: int, pixel: int, row: int, h: int) -> bytes:
    """TgaRleDecode.c: packets of a header byte (bit 7 a run, the low 7 bits
    the count less one) and `pixel` bytes a pixel, into h rows of `row`
    bytes; literals run on into the next row, runs that cross a row's end
    are refused."""
    need, out, n = row * h, bytearray(), len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("TGA: truncated run-length data")
        c = data[pos]
        count = pixel * ((c & 0x7F) + 1)
        if c & 0x80:
            if pos + 1 + pixel > n:
                raise ValueError("TGA: truncated run-length data")
            if len(out) % row + count > row:
                raise ValueError("TGA: a run packet crosses a row's end (PIL's buffer overrun)")
            out += data[pos + 1:pos + 1 + pixel] * (count // pixel)
            pos += 1 + pixel
        else:
            if pos + 1 + count > n:
                raise ValueError("TGA: truncated run-length data")
            out += data[pos + 1:pos + 1 + count]
            pos += 1 + count
    return bytes(out[:need])


def decode_tga(data: bytes) -> np.ndarray:
    if len(data) < 18:
        raise NotThisFormat("TGA: truncated header")
    id_len, cmap_type, kind = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w == 0 or h == 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("TGA: not a TGA header")
    if kind not in (1, 2, 3, 9, 10, 11):
        raise NotThisFormat(f"TGA: unknown image type {kind}")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        first, size, entry = struct.unpack("<HHB", data[3:8])
        nbytes = {16: 2, 24: 3, 32: 4}.get(entry)
        if nbytes is None:
            raise NotThisFormat(f"TGA: unknown colour-map depth {entry}")
        raw = data[pos:pos + nbytes * size]
        pos += len(raw)
        if entry == 32:
            raise ValueError("TGA: a 32-bit colour map, whose raw mode PIL does not read")
        if first + len(raw) // nbytes > 256:
            raise ValueError(f"TGA: a colour map of {first + len(raw) // nbytes} entries, "
                             f"more than PIL's palette takes")
        entries = np.frombuffer(raw[:len(raw) // nbytes * nbytes], np.uint8).reshape(-1, nbytes)
        palette = np.zeros((256, 3), np.uint8)
        palette[first:first + len(entries)] = (_bgr15(entries) if nbytes == 2
                                               else entries[:, 2::-1])
    check_size("TGA", w, h)
    rawmode = _RAWMODES.get((kind & 7, depth))
    if rawmode is None:
        raise ValueError(f"TGA: image type {kind} at {depth} bits, which PIL opens and "
                         f"cannot load")
    if rawmode == "P" and palette is None:
        raise ValueError("TGA: a colour-mapped image without a colour map, which PIL "
                         "opens as L and cannot load")
    if rawmode != "P" and palette is not None:
        raise ValueError("TGA: a colour map beside true-colour or grey pixels, which PIL "
                         "cannot load")
    if kind & 8 and depth == 1:
        raise ValueError("TGA: run-length 1-bit pixels, which PIL cannot load (its "
                         "decoder counts depth // 8 bytes a pixel)")
    row = (w * depth + 7) // 8
    if kind & 8:
        raw = _rle(data, pos, depth // 8, row, h)
    elif len(data) < pos + row * h:
        raise ValueError("TGA: truncated image data")
    else:
        raw = data[pos:pos + row * h]
    rows = np.frombuffer(raw, np.uint8).reshape(h, row)
    if rawmode == "1":
        rgb = _bilevel(rows, w)
    elif rawmode == "BGRA;15Z":
        rgb = _bgr15(rows.reshape(h, w, 2))
    elif rawmode in ("BGR", "BGRA"):
        rgb = rows.reshape(h, w, -1)[..., 2::-1]
    else:                                   # L, LA: the grey byte; P: through the map
        grey = rows.reshape(h, w, -1)[..., 0]
        rgb = palette[grey] if rawmode == "P" else np.repeat(grey[..., None], 3, -1)
    if not flags & 0x20:                    # bottom-up, PIL's orientation -1
        rgb = rgb[::-1]
    if flags & 0x10:                        # right-to-left: PIL's FLIP_LEFT_RIGHT
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)
