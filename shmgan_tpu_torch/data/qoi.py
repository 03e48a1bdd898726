"""QOI ("Quite OK Image") as PIL 12's QoiImagePlugin reads it, to its
`convert("RGB")` pixels.

    rgb = decode_qoi(data)                    # (H, W, 3) uint8

The header: `qoif`, width and height (big-endian), channels (3 is RGB,
any other count RGBA, whose alpha `convert("RGB")` drops) and a colour
space byte. Then QoiDecoder's ops, as it runs them: QOI_OP_RGB and
QOI_OP_RGBA (a whole pixel), QOI_OP_INDEX (the running array of 64 by
(3r + 5g + 7b + 11a) % 64; a slot never written reads (0, 0, 0, 0)),
QOI_OP_DIFF and QOI_OP_LUMA (from the previous pixel, modulo 256) and
QOI_OP_RUN (the previous pixel again, which PIL does not write back to the
array). The previous pixel starts as (0, 0, 0, 255). Ops run until the
pixels are filled (a run past the end is cut); the end marker is not
read. A stream that ends first is refused.
"""

from __future__ import annotations

import struct

import numpy as np

from shmgan_tpu_torch.data.codecs import NotThisFormat, check_size


def decode_qoi(data: bytes) -> np.ndarray:
    if len(data) < 13:
        raise NotThisFormat("QOI: truncated header")
    w, h = struct.unpack(">II", data[4:12])
    if w == 0 or h == 0:
        raise NotThisFormat("QOI: empty image")
    check_size("QOI", w, h)
    need, out = w * h, bytearray()
    index = [None] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, n = 14, len(data)
    pixels = 0
    try:
        while pixels < need:
            op = data[pos]
            pos += 1
            if op == 0xFE:                          # QOI_OP_RGB
                if pos + 3 > n:
                    raise IndexError
                r, g, b = data[pos], data[pos + 1], data[pos + 2]
                pos += 3
            elif op == 0xFF:                        # QOI_OP_RGBA
                if pos + 4 > n:
                    raise IndexError
                r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
                pos += 4
            elif op < 0x40:                         # QOI_OP_INDEX
                r, g, b, a = index[op] or (0, 0, 0, 0)
            elif op < 0x80:                         # QOI_OP_DIFF
                r = (r + ((op >> 4) & 3) - 2) & 0xFF
                g = (g + ((op >> 2) & 3) - 2) & 0xFF
                b = (b + (op & 3) - 2) & 0xFF
            elif op < 0xC0:                         # QOI_OP_LUMA
                second = data[pos]
                pos += 1
                dg = (op & 0x3F) - 32
                r = (r + dg + (second >> 4) - 8) & 0xFF
                g = (g + dg) & 0xFF
                b = (b + dg + (second & 0x0F) - 8) & 0xFF
            else:                                   # QOI_OP_RUN: not written to the array
                run = min((op & 0x3F) + 1, need - pixels)
                out += bytes((r, g, b)) * run
                pixels += run
                continue
            index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
            out += bytes((r, g, b))
            pixels += 1
    except IndexError:
        raise ValueError("QOI: truncated image data") from None
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, 3)
