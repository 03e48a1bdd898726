"""Stream writers for the tests of the port's TGA, PSD, ICO/CUR, ICNS, QOI,
PCX/DCX, SGI, PFM, MSP, XBM and DDS decoders: the layouts PIL writes are
made with PIL; the rest (PSD, CUR, SGI RLE, MSP v2, ICNS RLE entries,
DDS headers, EGA PCX, odd TGA headers) by hand here, from each format's
published layout."""

import io
import struct

import numpy as np
from PIL import Image


def photo(h, w, seed=0):
    """A smooth, noisy uint8 RGB image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0), 128 + 80 * np.cos(yy / 5.0),
                    (2 * xx + yy) % 256], -1) + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def pil_open(data):
    """PIL's verdict on the bytes: ("TGA", pixels), ("TGA", None) where it
    opens and cannot convert, or (None, None) where Image.open refuses."""
    try:
        im = Image.open(io.BytesIO(data))
    except Exception:
        return None, None
    try:
        return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return im.format, None


# -- TGA ---------------------------------------------------------------------------

def tga(w, h, kind, depth, body, cmap=b"", first=0, count=None, cmap_depth=0, flags=0,
        ident=b"", cmap_type=None):
    if cmap_type is None:
        cmap_type = 1 if cmap or cmap_depth else 0
    if count is None:
        count = len(cmap) // max(1, cmap_depth // 8) if cmap_depth else 0
    return (bytes([len(ident), cmap_type, kind]) + struct.pack("<HHB", first, count, cmap_depth)
            + struct.pack("<HHHH", 0, 0, w, h) + bytes([depth, flags]) + ident + cmap + body)


def tga_rle(rows, pixel, seed=0):
    """Run-length packets over rows of `pixel`-byte pixels: runs within a
    row, literals that may run on into the next row."""
    rng = np.random.default_rng(seed)
    flat = b"".join(rows)
    row = len(rows[0])
    px = [flat[i:i + pixel] for i in range(0, len(flat), pixel)]
    out, i = bytearray(), 0
    while i < len(px):
        j = i
        end_of_row = (i * pixel // row + 1) * row // pixel
        while j + 1 < min(len(px), end_of_row, i + 128) and px[j + 1] == px[i]:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + px[i]
            i = j + 1
            continue
        n = int(min(len(px) - i, rng.integers(1, 129)))
        out += bytes([n - 1]) + b"".join(px[i:i + n])
        i += n
    return bytes(out)


# -- PSD ---------------------------------------------------------------------------

def packbits_row(row):
    """One row in PackBits: runs of 3 or more, literals of the rest."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and j - i < 127 and row[j + 1] == row[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        k = i
        while k + 1 < n and k - i < 127 and not (k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += bytes([k - i]) + bytes(row[i:k + 1])
        i = k + 1
    return bytes(out)


def psd(planes, colour, bits=8, channels=None, compression=0, colour_data=b"",
        resources=(), layers=b""):
    """A PSD of `planes` (c, h, row bytes) uint8: header, colour-mode data,
    resources ((id, name, data)), a layer section, the image data."""
    planes = np.asarray(planes, np.uint8)
    c, h, row = planes.shape
    w = row * 8 if bits == 1 else row
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits, colour)
    out += struct.pack(">I", len(colour_data)) + colour_data
    res = b""
    for rid, name, data in resources:
        pname = bytes([len(name)]) + name + (b"\0" if not len(name) & 1 else b"")
        res += b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(">I", len(data)) + data + (
            b"\0" if len(data) & 1 else b"")
    out += struct.pack(">I", len(res)) + res
    out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 0:
        return out + planes.tobytes()
    rows = [packbits_row(bytes(planes[k, y])) for k in range(c) for y in range(h)]
    return out + b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)


# -- DIB, ICO, CUR -----------------------------------------------------------------

def dib(idx, bits, palette=None, mask=None):
    """A BITMAPINFOHEADER DIB of twice the height (the XOR bitmap, then the
    AND mask): `idx` (h, w) indices for 1-8 bits, (h, w, 3) RGB for 24,
    (h, w, 4) for 32."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    if bits <= 8:
        per = 8 // bits
        for x in range(w):
            rows[:, x // per] |= idx[:, x] << (8 - bits - bits * (x % per))
    else:
        nb = bits // 8
        px = idx[..., [2, 1, 0, 3][:nb]]
        rows[:, :w * nb] = px.reshape(h, w * nb)
    colours = 0 if bits > 8 else 1 << bits
    pal = b""
    if bits <= 8:
        pal = np.zeros((colours, 4), np.uint8)
        pal[:, :3] = np.asarray(palette, np.uint8)[:colours, ::-1]
        pal = pal.tobytes()
    mstride = (w + 31) // 32 * 4
    andmask = np.zeros((h, mstride), np.uint8) if mask is None else mask
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colours, 0)
    return head + pal + rows[::-1].tobytes() + np.asarray(andmask, np.uint8)[::-1].tobytes()


def icon_dir(kind, entries):
    """An ICO (kind 1) or CUR (kind 2): entries of (w, h, bits, body)."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    bodies = b""
    for w, h, bits, body in entries:
        out += bytes([w % 256, h % 256, 0, 0]) + struct.pack("<HHII", 1, bits, len(body),
                                                             offset + len(bodies))
        bodies += body
    return out + bodies


# -- ICNS --------------------------------------------------------------------------

def icns_rle(plane):
    """Apple's run-length code: b >= 128 repeats the next byte b - 125
    times (3 to 130), b < 128 is b + 1 literal bytes."""
    data, out, i = bytes(plane), bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and j - i < 129 and data[j + 1] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([j - i + 1 + 125, data[i]])
            i = j + 1
            continue
        k = min(len(data), i + 128)
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def icns(blocks):
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


# -- SGI, DDS, MSP -----------------------------------------------------------------

def sgi(planes, bpc=1, rle=False, dim=None):
    """An SGI of `planes` (z, h, w) (top row first), raw or RLE."""
    planes = np.asarray(planes)
    z, h, w = planes.shape
    dim = dim or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, dim, w, h, z) + bytes(500)
    dt = ">u2" if bpc == 2 else np.uint8
    stored = planes[:, ::-1].astype(dt)
    if not rle:
        return head + stored.tobytes()
    rows, starts, lengths = [], [], []
    pos = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            r = stored[c, y]
            words, x = [], 0
            while x < w:
                n = min(127, w - x)
                if x + 1 < w and r[x + 1] == r[x]:
                    k = x
                    while k < w and k - x < 127 and r[k] == r[x]:
                        k += 1
                    words += [k - x, int(r[x])]
                    x = k
                else:
                    words += [0x80 | n] + [int(v) for v in r[x:x + n]]
                    x += n
            words.append(0)
            row = np.asarray(words, dt).tobytes()
            starts.append(pos)
            lengths.append(len(row))
            rows.append(row)
            pos += len(row)
    return (head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lengths)
            + b"".join(rows))


def dds(w, h, pf_flags, fourcc=b"\0\0\0\0", bits=0, masks=(0, 0, 0, 0), body=b"", dxgi=None):
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<II4sI4I", 32, pf_flags, fourcc, bits, *masks) + bytes(20)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def msp_v2(bits_rows):
    """MSP v2 (LinS) of (h, stride) packed rows: each row as runs of equal
    bytes (0, count, value) and literals (count, bytes)."""
    h, stride = bits_rows.shape
    w = stride * 8
    rows = []
    for r in bits_rows:
        r, out, i = bytes(r), bytearray(), 0
        while i < len(r):
            j = i
            while j + 1 < len(r) and j - i < 254 and r[j + 1] == r[i]:
                j += 1
            if j > i:
                out += bytes([0, j - i + 1, r[i]])
                i = j + 1
            else:
                out += bytes([1, r[i]])
                i += 1
        rows.append(b"" if r == b"\xff" * stride else bytes(out))
    words = [0x694C, 0x536E, w, h, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]
    words[12] = 0
    x = 0
    for v in words:
        x ^= v
    words[15] = x                      # the 16 words XOR to 0
    return (struct.pack("<16H", *words) + struct.pack(f"<{h}H", *map(len, rows))
            + b"".join(rows))
