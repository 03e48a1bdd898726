"""GIF decoding in numpy and the standard library: the first frame, as PIL's
`Image.open(...).convert("RGB")` gives it.

    rgb = decode_gif(data)      # (H, W, 3) uint8

The logical screen and the first image descriptor are read, extension
blocks skipped; the frame's variable-width LZW codes (clear and end codes,
a full table kept until the next clear) are decoded, rows put back in
place when interlaced, and the indices looked up in the local colour table,
else the global one. As PIL: transparency is ignored (the transparent index
shows its table colour), pixels outside the frame are index 0 (the
transparent index when there is one), a colour table that is the identity
ramp or missing makes the index the grey level, and indices past a table
read black. Later frames are not read.
"""

from __future__ import annotations

import numpy as np

from shmgan_tpu_torch.data.codecs import check_size

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))     # (first row, step) of each pass


def _sub_blocks(data: bytes, pos: int):
    """Concatenated data sub-blocks from `pos`, and the position after their
    terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF: truncated (data sub-blocks cut off)")
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        if pos + 1 + n > len(data):
            raise ValueError("GIF: truncated (data sub-block cut off)")
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _lzw(stream: bytes, min_bits: int, n_pixels: int) -> bytes:
    """GIF LZW (codes packed least significant bit first) -> the first
    `n_pixels` indices."""
    if not 1 <= min_bits <= 11:
        raise ValueError(f"GIF: LZW minimum code size {min_bits}")
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_bits + 1
    out = bytearray()
    prev = None
    acc = nacc = 0
    pos, n = 0, len(stream)
    while len(out) < n_pixels:
        while nacc < size:
            if pos >= n:
                raise ValueError("GIF: truncated (LZW data ends early)")
            acc |= stream[pos] << nacc
            pos += 1
            nacc += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            table = list(base)
            size = min_bits + 1
            prev = None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise ValueError("GIF: corrupt LZW data")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    if len(out) < n_pixels:
        raise ValueError("GIF: truncated (fewer pixels than the frame holds)")
    return bytes(out[:n_pixels])


def _colour_table(data: bytes, pos: int, flags: int):
    """The colour table a flags byte announces at `pos`: (palette or None
    for none or PIL's identity ramp, position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 3 << ((flags & 7) + 1)
    raw = data[pos:pos + n]
    if len(raw) < n:
        raise ValueError("GIF: truncated colour table")
    entries = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (entries == np.arange(len(entries))[:, None]).all():
        return None, pos + n            # PIL reads an identity ramp as mode L
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(entries)] = entries
    return palette, pos + n


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame."""
    data = bytes(data)
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("GIF: no header")
    sw, sh = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    palette, pos = _colour_table(data, 13, data[10])
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[pos]
        if kind == 0x21:                               # extension
            if pos + 2 > len(data):
                raise ValueError("GIF: truncated extension")
            label = data[pos + 1]
            block, after = _sub_blocks(data, pos + 2)
            if label == 0xF9 and pos + 2 < len(data) and data[pos + 2] >= 4:
                first = data[pos + 3:pos + 3 + data[pos + 2]]
                if first[0] & 1:
                    transparency = first[3]
            pos = after
        elif kind == 0x2C:                             # image descriptor
            if pos + 10 > len(data):
                raise ValueError("GIF: truncated image descriptor")
            x0, y0, fw, fh = np.frombuffer(data, "<u2", 4, pos + 1).tolist()
            flags = data[pos + 9]
            local, pos = _colour_table(data, pos + 10, flags)
            if flags & 0x80:
                palette = local
            if pos >= len(data):
                raise ValueError("GIF: truncated image data")
            min_bits = data[pos]
            stream, _ = _sub_blocks(data, pos + 1)
            break
        else:
            raise ValueError(f"GIF: corrupt block 0x{kind:02x}")
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    if w == 0 or h == 0:
        raise ValueError("GIF: empty image")
    check_size("GIF", w, h)
    idx = np.full((h, w), transparency or 0, np.uint8)
    if fw and fh:
        frame = np.frombuffer(_lzw(stream, min_bits, fw * fh), np.uint8).reshape(fh, fw)
        if flags & 0x40:
            rows = np.concatenate([np.arange(s, fh, step) for s, step in _INTERLACE])
            placed = np.empty_like(frame)
            placed[rows] = frame
            frame = placed
        idx[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return np.repeat(idx[..., None], 3, -1)
    return palette[idx]
