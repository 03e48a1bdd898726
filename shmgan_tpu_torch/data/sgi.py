"""SGI (Silicon Graphics) images as PIL 12's SgiImagePlugin reads them, to
their `convert("RGB")` pixels.

    rgb = decode_sgi(data)                    # (H, W, 3) uint8

The 512-byte header: magic 474, storage (0 raw, 1 RLE), bytes a channel
(1 or 2), dimension, x, y and z sizes, big-endian. PIL reads the
(bytes, dimension, z) of its MODES table: grey (z 1, dimension 1 or 2),
RGB (z 3) and RGBA (z 4, alpha dropped), at 8 or 16 bits (the high byte
of each big-endian sample, PIL's ;16B raw modes); anything else is refused
as PIL refuses it. Channels are planar and rows bottom-up. RLE
(SgiRleDecode.c): a table of row offsets then one of row lengths (z * y
big-endian words each, channel-major); a row is packets of a count byte
(low 7 bits; 0 ends the row), a literal of that many samples if its top
bit is set, else one sample repeated; in 16-bit files counts and samples
are 16-bit words. A row that overruns its width, a table entry past the
file's end, or a body cut short is refused.
"""

from __future__ import annotations

import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, check_size

# PIL's MODES: (bytes a channel, dimension, z size) -> mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
          (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def _rle_row(data: bytes, start: int, length: int, w: int, bpc: int, y: int) -> np.ndarray:
    """One channel's row (SgiRleDecode.c's expandrow, expandrow2 for 16
    bits) -> (w,) samples of `bpc` bytes, as uint8 or big-endian uint16."""
    dt = np.dtype(">u2") if bpc == 2 else np.dtype(np.uint8)
    src = np.frombuffer(data, dt, count=length // bpc, offset=start)
    out = np.zeros(w, dt)
    x, i, n = 0, 0, len(src)
    while i < n:
        c = int(src[i])
        i += 1
        count = c & 0x7F
        if not count:
            return out
        if x + count > w:
            raise ValueError(f"SGI: RLE row {y} overruns its width")
        if c & 0x80:
            if i + count > n:
                raise ValueError(f"SGI: RLE row {y} is cut short")
            out[x:x + count] = src[i:i + count]
            i += count
        else:
            if i >= n:
                raise ValueError(f"SGI: RLE row {y} is cut short")
            out[x:x + count] = src[i]
            i += 1
        x += count
    raise ValueError(f"SGI: RLE row {y} has no end packet")


def decode_sgi(data: bytes) -> np.ndarray:
    if len(data) < 12:
        raise NotThisFormat("SGI: truncated header")
    storage, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack(">HHHH", data[4:12])
    mode = _MODES.get((bpc, dim, z))
    if mode is None:
        raise ValueError(f"SGI: {bpc} bytes a channel, dimension {dim}, {z} channels, "
                         f"PIL's unsupported SGI image mode")
    if w == 0 or h == 0:
        raise NotThisFormat("SGI: empty image")
    if storage not in (0, 1):
        raise ValueError(f"SGI: storage {storage}, which PIL opens and cannot load")
    check_size("SGI", w, h)
    if storage == 0:
        size = w * h * bpc * z
        if len(data) < 512 + size:
            raise ValueError("SGI: truncated image data")
        dt = ">u2" if bpc == 2 else np.uint8
        planes = np.frombuffer(data, dt, count=w * h * z, offset=512).reshape(z, h, w)
    else:
        table = 512 + 8 * h * z
        if len(data) < table:
            raise ValueError("SGI: truncated RLE tables")
        starts = struct.unpack_from(f">{h * z}I", data, 512)
        lengths = struct.unpack_from(f">{h * z}I", data, 512 + 4 * h * z)
        planes = np.zeros((z, h, w), ">u2" if bpc == 2 else np.uint8)
        for c in range(z):
            for y in range(h):
                start, length = starts[c * h + y], lengths[c * h + y]
                if start < 512 or start + length > len(data):
                    raise ValueError(f"SGI: RLE row {y} of channel {c} lies past the file")
                planes[c, y] = _rle_row(data, start, length, w, bpc, y)
    if bpc == 2:
        planes = (planes >> 8).astype(np.uint8)      # PIL's ;16B raw modes: the high byte
    planes = planes[:, ::-1]                          # rows bottom-up
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, -1)
    return np.ascontiguousarray(np.moveaxis(planes[:3], 0, -1))
