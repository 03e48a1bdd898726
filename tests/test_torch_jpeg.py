"""The port's JPEG decoder (data/jpeg.py) against PIL (libjpeg-turbo), on the
CPU: seeded images written by PIL at every quality, subsampling,
`optimize`, `progressive`, restart interval, 16-bit quantisation tables,
greyscale, Adobe RGB, CMYK and YCCK (Adobe's inverted convention, as PIL
reads it), EXIF orientation and odd sizes decode to PIL's `convert("RGB")`
pixels exactly; so do files of hand-made coefficients at the sampling
layouts PIL's encoder does not write (h1v2, 4:1:1, mixed chroma factors,
planes 1 and 2 samples wide, four components). The kinds the port refuses
raise ValueError naming the feature; a file cut short raises. A JPEG tree
goes through `decode_resize`, `decode_original` and `PolarimetricDataset`
to the JAX loader's float32 arrays bit for bit."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.config import DataConfig as JDataConfig
from shmgan_tpu.data.loader import PolarimetricDataset as JPolarimetricDataset
from shmgan_tpu.data.loader import decode_original as j_decode_original
from shmgan_tpu.data.loader import decode_resize as j_decode_resize
from shmgan_tpu_torch.config import DataConfig
from shmgan_tpu_torch.data import jpeg as _port_jpeg
from shmgan_tpu_torch.data.jpeg import decode_jpeg
from shmgan_tpu_torch.data.loader import PolarimetricDataset, decode_original, decode_resize
from shmgan_tpu_torch.data.synthetic import camera_image, synth_polar_scene


def _photo(h, w, seed=0, noise=12.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0), 128 + 80 * np.cos(yy / 5.0),
                    (2 * xx + yy) % 256], -1) + rng.normal(0, noise, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _same_as_pil(data):
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_baseline_every_quality_and_subsampling(quality, subsampling):
    _same_as_pil(_jpeg(_photo(37, 53, seed=quality), quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("options", [
    dict(optimize=True), dict(progressive=True), dict(progressive=True, subsampling=0),
    dict(progressive=True, quality=95, subsampling=1), dict(restart_marker_blocks=1),
    dict(restart_marker_blocks=7, subsampling=0), dict(restart_marker_rows=1, progressive=True),
    dict(keep_rgb=True), dict(keep_rgb=True, progressive=True),
    dict(qtables=[[300 + 9 * i for i in range(64)], [500 + 7 * i for i in range(64)]]),
    dict(optimize=True, progressive=True, quality=30)], ids=str)
def test_encoder_options(options):
    _same_as_pil(_jpeg(_photo(45, 61, seed=1), **options))


@pytest.mark.parametrize("progressive", [False, True])
def test_greyscale(progressive):
    data = _jpeg(_photo(29, 31, seed=2)[..., 0].copy(), progressive=progressive)
    assert decode_jpeg(data).shape == (29, 31, 3)
    _same_as_pil(data)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (2, 3), (3, 2), (8, 8), (9, 17),
                                   (17, 23), (16, 33), (31, 7)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_odd_sizes(shape, subsampling):
    _same_as_pil(_jpeg(_photo(*shape, seed=3), subsampling=subsampling))


def test_exif_orientation_is_not_applied():
    ex = Image.Exif()
    ex[0x0112] = 6
    img = _photo(20, 36, seed=4)
    data = _jpeg(img, exif=ex.tobytes())
    assert decode_jpeg(data).shape == (20, 36, 3)
    _same_as_pil(data)


def test_camera_image_of_a_synthetic_scene():
    views, diffuse, _ = synth_polar_scene(np.random.default_rng(5), 96, 128)
    img = (np.clip(camera_image(diffuse, views), 0, 1) * 255).astype(np.uint8)
    for quality in (50, 90):
        _same_as_pil(_jpeg(img, quality=quality))


def test_rgb_component_ids_without_adobe_segment():
    """keep_rgb writes component ids 'R', 'G', 'B' and an Adobe segment;
    without the segment libjpeg reads the ids as RGB too."""
    data = _jpeg(_photo(24, 24, seed=6), keep_rgb=True)
    i = data.index(b"\xff\xee")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    _same_as_pil(data[:i] + data[i + 2 + n:])


def test_stray_bytes_and_fill_bytes_between_segments():
    data = _jpeg(_photo(16, 16, seed=7))
    i = data.index(b"\xff\xdb")
    _same_as_pil(data[:i] + b"\xff\xff\xff" + data[i:])


# -- files of hand-made coefficients ------------------------------------------------

# JPEG Annex K.3: the example luminance DC and AC tables
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a"
    "161718191a25262728292a3435363738393a434445464748494a535455565758595a6364656667"
    "68696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3"
    "b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
    "f5f6f7f8f9fa")
_ZZ = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
       34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
       37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _codes(bits, vals):
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def _encode(width, height, factors, coefs, q=4):
    """A baseline JPEG (no JFIF segment: ids 1, 2, 3 mean YCbCr) of
    quantised coefficients: coefs[c] is (rows, cols, 64) natural order over
    component c's blocks of the padded MCU grid."""
    dc, ac = _codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)
    bits = []

    def put(code, n):
        bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))

    def value(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    pred = [0] * len(factors)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(factors):
                for i in range(v):
                    for j in range(h):
                        blk = coefs[c][my * v + i, mx * h + j]
                        zz = [int(blk[p]) for p in _ZZ]
                        s, b = value(zz[0] - pred[c])
                        pred[c] = zz[0]
                        put(*dc[s])
                        put(b, s)
                        run = 0
                        last = max([k for k in range(1, 64) if zz[k]] or [0])
                        for k in range(1, last + 1):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            s, b = value(zz[k])
                            put(*ac[(run << 4) | s])
                            put(b, s)
                            run = 0
                        if last < 63:
                            put(*ac[0x00])
    bits.extend([1] * (-len(bits) % 8))
    data = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
    data = data.replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    nc = len(factors)
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([nc])
    sof += b"".join(bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(factors))
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x00]) for c in range(nc)) + bytes([0, 63, 0])
    return (b"\xff\xd8" + seg(0xDB, bytes([0]) + bytes([q] * 64)) + seg(0xC0, sof)
            + seg(0xC4, bytes([0x00] + _DC_BITS) + bytes(_DC_VALS))
            + seg(0xC4, bytes([0x10] + _AC_BITS) + _AC_VALS)
            + seg(0xDA, sos) + data + b"\xff\xd9")


def _coefs(width, height, factors, seed):
    """Smooth blocks: a DC random walk and a few low-frequency AC terms."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    out = []
    for h, v in factors:
        rows, cols = -(-height // (8 * vmax)) * v, -(-width // (8 * hmax)) * h
        c = np.zeros((rows, cols, 64), np.int64)
        c[..., 0] = np.cumsum(rng.integers(-6, 7, (rows, cols)), axis=1) % 60 - 30
        for p in (1, 8, 9, 2, 16):
            c[..., p] = rng.integers(-4, 5, (rows, cols))
        out.append(c)
    return out


@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)),          # h1v2
    ((2, 1), (1, 1), (1, 1)),          # h2v1
    ((2, 2), (1, 1), (1, 1)),          # h2v2
    ((4, 1), (1, 1), (1, 1)),          # 4:1:1, box replication
    ((2, 2), (2, 1), (1, 1)),          # h1v2 and h2v2 chroma in one file
    ((2, 2), (1, 2), (2, 2)),          # h2v1 chroma, full-size chroma
    ((1, 1), (1, 1), (1, 1)),
    ((2, 2),),                         # greyscale with 2x2 factors: one block an MCU
    ((2, 2), (1, 1), (1, 1), (2, 2)),  # CMYK (no Adobe segment), C and K full size
], ids=str)
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (5, 4), (24, 17), (40, 33)], ids=str)
def test_hand_made_sampling_layouts(factors, size):
    width, height = size
    data = _encode(width, height, factors, _coefs(width, height, factors, seed=width * height))
    _same_as_pil(data)


# -- arithmetic coding (SOF9, SOF10) and lossless (SOF3) ------------------------------

# jaricom.c's Table D.2 as the encoder reads it: (Qe, next after LPS, next after MPS, switch)
_QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass: one restart interval's
    entropy-coded bytes (stuffed), statistics in bytearrays of state bytes
    (MPS in bit 7)."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _emit(self, b):
        self.out.append(b)

    def _flush_pending(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nlps, nmps, switch = _QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ ((switch << 7) | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_pending()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_pending()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_pending()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0x8000000:
            if self.buffer >= 0:
                self._flush_pending()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_pending()
                self._emit(self.buffer)
            if self.sc:
                self._flush_pending()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_pending()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_value(enc, st, i, v, upper):
    """Figures F.8 and F.9 for |v| - 1 = v (> 0 allowed 0): the magnitude
    category from bin i (DC: its chain at 20; AC: at `upper`), then the bits."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m, v2 = 1, v
        if upper < 0:
            i = 20
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = upper
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
    enc.encode(st, i, 0)
    mag = m
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1
    return mag


def _arith_scans(blocks_of, order_of_mcus, scans, kx=5, dc_lu=(0, 1), restart=0):
    """Entropy-coded segments of jcarith.c's scans: `scans` lists (component
    indices, Ss, Se, Ah, Al); blocks_of(c) is (rows, cols, 64) natural order;
    order_of_mcus(comps) yields each MCU's [(c, row, col), ...]."""
    out = []
    fixed = bytearray([113])
    for comps, ss, se, ah, al in scans:
        mcus = list(order_of_mcus(comps))
        segs = []
        for start in range(0, len(mcus), restart or len(mcus)):
            enc = _QMEncoder()
            dc_st = {c: bytearray(64) for c in comps}
            ac_st = {c: bytearray(256) for c in comps}
            dc_st = dict.fromkeys(comps, dc_st[comps[0]])    # every component: table 0
            ac_st = dict.fromkeys(comps, ac_st[comps[0]])
            last, ctx = {c: 0 for c in comps}, {c: 0 for c in comps}
            for mcu in mcus[start:start + (restart or len(mcus))]:
                for c, r, q in mcu:
                    blk = blocks_of(c)[r, q]
                    zz = [int(blk[p]) for p in _ZZ]
                    st = dc_st[c]
                    if ss == 0 and ah:                   # DC refinement
                        enc.encode(fixed, 0, (zz[0] >> al) & 1)
                        continue
                    if ss == 0:
                        dc = zz[0] >> al
                        v = dc - last[c]
                        i = ctx[c]
                        if v == 0:
                            enc.encode(st, i, 0)
                            ctx[c] = 0
                        else:
                            last[c] = dc
                            enc.encode(st, i, 1)
                            enc.encode(st, i + 1, 0 if v > 0 else 1)
                            ctx[c] = 4 if v > 0 else 8
                            m = _arith_value(enc, st, i + (2 if v > 0 else 3), abs(v) - 1, -1)
                            if m < (1 << dc_lu[0]) >> 1:
                                ctx[c] = 0
                            elif m > (1 << dc_lu[1]) >> 1:
                                ctx[c] += 8
                        if len(scans) > 1 and se == 0:
                            continue
                        ss_, se_ = 1, 63
                    else:
                        ss_, se_ = ss, se
                    st = ac_st[c]
                    t = [(-((-x) >> al) if x < 0 else x >> al) for x in zz]
                    if ah == 0:
                        ke = se_
                        while ke >= ss_ and t[ke] == 0:
                            ke -= 1
                        k = ss_
                        while k <= ke:
                            i = 3 * (k - 1)
                            enc.encode(st, i, 0)
                            while t[k] == 0:
                                enc.encode(st, i + 1, 0)
                                i += 3
                                k += 1
                            enc.encode(st, i + 1, 1)
                            enc.encode(fixed, 0, 1 if t[k] < 0 else 0)
                            _arith_value(enc, st, i + 2, abs(t[k]) - 1,
                                         189 if k <= kx else 217)
                            k += 1
                        if k <= se_:
                            enc.encode(st, 3 * (k - 1), 1)
                        continue
                    prev = [(-((-x) >> ah) if x < 0 else x >> ah) for x in zz]
                    ke = se_
                    while ke >= ss_ and t[ke] == 0:
                        ke -= 1
                    kex = ke
                    while kex >= ss_ and prev[kex] == 0:
                        kex -= 1
                    k = ss_
                    while k <= ke:
                        i = 3 * (k - 1)
                        if k > kex:
                            enc.encode(st, i, 0)
                        while True:
                            if t[k]:
                                if prev[k]:
                                    enc.encode(st, i + 2, abs(t[k]) & 1)
                                else:
                                    enc.encode(st, i + 1, 1)
                                    enc.encode(fixed, 0, 1 if t[k] < 0 else 0)
                                break
                            enc.encode(st, i + 1, 0)
                            i += 3
                            k += 1
                        k += 1
                    if k <= se_:
                        enc.encode(st, 3 * (k - 1), 1)
            segs.append(enc.finish())
        out.append(segs)
    return out


def _arith_jpeg(width, height, factors, coefs, progressive=False, restart=0, dac=None,
                q=4, jfif=False):
    """An arithmetic-coded JPEG (SOF9, or SOF10 with a spectral-selection and
    successive-approximation script) of quantised coefficients laid out as
    _encode takes them; `dac` {index: value} written as a DAC segment."""
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    nc = len(factors)

    def order_of_mcus(comps):
        if len(comps) == 1:
            c = comps[0]
            h, v = factors[c]
            rows = -(-(-(-height * v // vmax)) // 8)
            cols = -(-(-(-width * h // hmax)) // 8)
            return ([(c, r, q_)] for r in range(rows) for q_ in range(cols))
        return ([(c, my * factors[c][1] + i, mx * factors[c][0] + j) for c in comps
                 for i in range(factors[c][1]) for j in range(factors[c][0])]
                for my in range(mcuy) for mx in range(mcux))

    if progressive:
        scans = [(list(range(nc)), 0, 0, 0, 1)] + [([c], 1, 5, 0, 1) for c in range(nc)] \
            + [([c], 6, 63, 0, 1) for c in range(nc)] + [(list(range(nc)), 0, 0, 1, 0)] \
            + [([c], 1, 63, 1, 0) for c in range(nc)]
    else:
        scans = [(list(range(nc)), 0, 63, 0, 0)]
    cond = dac or {}
    dc_lu = (cond.get(0, 0x10) & 15, cond.get(0, 0x10) >> 4)
    segs = _arith_scans(lambda c: coefs[c], order_of_mcus, scans, kx=cond.get(16, 5),
                        dc_lu=dc_lu, restart=restart)

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([nc])
    sof += b"".join(bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(factors))
    out = b"\xff\xd8"
    if jfif:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, bytes([0]) + bytes([q] * 64)) + seg(0xCA if progressive else 0xC9, sof)
    if dac:
        out += seg(0xCC, b"".join(bytes([k, v]) for k, v in dac.items()))
    if restart:
        out += seg(0xDD, restart.to_bytes(2, "big"))
    for (comps, ss, se, ah, al), pieces in zip(scans, segs):
        sos = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x00]) for c in comps)
        out += seg(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        for n, piece in enumerate(pieces):
            out += piece
            if n < len(pieces) - 1:
                out += bytes([0xFF, 0xD0 + n % 8])
    return out + b"\xff\xd9"


def arith_version(jpeg: bytes, progressive=False, restart=0) -> bytes:
    """A Huffman-coded JPEG's coefficients, quantisation tables, sampling
    and JFIF segment, arithmetic-coded (SOF9, or SOF10): the same pixels."""
    comps, (width, height, *_), jfif, _ = _port_jpeg._read(jpeg)
    nat = np.argsort(np.array(_ZZ))                 # natural position -> zigzag index
    coefs = [np.frombuffer(c.coefs, np.int32).reshape(c.bh, c.bw, 64)[..., nat]
             for c in comps]
    data = _arith_jpeg(width, height, [(c.h, c.v) for c in comps], coefs,
                       progressive=progressive, restart=restart, jfif=jfif)
    i = data.index(b"\xff\xdb")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    dqt = b"".join(bytes([tq]) + bytes(comps[[c.tq for c in comps].index(tq)].quant)
                   for tq in sorted({c.tq for c in comps}))
    data = data[:i] + b"\xff\xdb" + (len(dqt) + 2).to_bytes(2, "big") + dqt + data[i + 2 + n:]
    j = data.index(b"\xff\xc9" if not progressive else b"\xff\xca") + 4
    sof = bytearray(data[j:j + 6 + 3 * len(comps)])
    for k, c in enumerate(comps):
        sof[6 + 3 * k + 2] = c.tq
    return data[:j] + bytes(sof) + data[j + len(sof):]


def _arith_coefs(width, height, factors, seed):
    """_coefs with more, larger AC terms: every magnitude category and
    both conditioning regions of the AC statistics are exercised."""
    out = _coefs(width, height, factors, seed)
    rng = np.random.default_rng(seed + 1)
    for c in out:
        c[..., 0] = np.cumsum(rng.integers(-40, 41, c.shape[:2]), axis=1) % 200 - 100
        for p in rng.choice(np.arange(1, 64), 12, replace=False):
            c[..., p] = np.where(rng.random(c.shape[:2]) < 0.5, 0,
                                 rng.integers(-70, 71, c.shape[:2]))
    return out


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("factors", [((1, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
                                     ((2, 1), (1, 1), (1, 1)), ((1, 1),)], ids=str)
@pytest.mark.parametrize("size", [(1, 1), (23, 17), (37, 29)], ids=str)
def test_arithmetic_coding_decodes_like_pil(progressive, factors, size):
    """Arithmetic-coded files of jcarith.c's encoder: PIL's libjpeg-turbo
    decodes them (jdarith.c), the port gives its pixels; and they are the
    pixels of the same coefficients Huffman-coded."""
    width, height = size
    coefs = _arith_coefs(width, height, factors, seed=width + 3 * height)
    data = _arith_jpeg(width, height, factors, coefs, progressive=progressive)
    _same_as_pil(data)
    huff = [np.clip(c, -1023, 1023) for c in coefs]
    if all(np.array_equal(a, b) for a, b in zip(huff, coefs)):
        np.testing.assert_array_equal(decode_jpeg(data),
                                      _pil_rgb(_encode(width, height, factors, coefs)))


@pytest.mark.parametrize("kw", [dict(), dict(progressive=True), dict(restart=2)], ids=str)
@pytest.mark.parametrize("subsampling", [0, 2])
def test_arithmetic_version_of_a_photo_is_its_pixels(kw, subsampling):
    """A PIL photo JPEG re-coded arithmetically: PIL and the port give the
    Huffman file's pixels."""
    base = _jpeg(_photo(37, 53, seed=12), quality=90, subsampling=subsampling)
    data = arith_version(base, **kw)
    np.testing.assert_array_equal(_pil_rgb(data), _pil_rgb(base))
    _same_as_pil(data)


@pytest.mark.parametrize("kw", [dict(restart=1), dict(restart=3, progressive=True),
                                dict(dac={0: 0x52, 16: 2}), dict(dac={0: 0x00, 16: 63}),
                                dict(dac={0: 0x31, 16: 0}, progressive=True), dict(jfif=True),
                                dict(q=1)], ids=str)
def test_arithmetic_restarts_and_conditioning(kw):
    factors = ((2, 2), (1, 1), (1, 1))
    coefs = _arith_coefs(40, 33, factors, seed=31)
    _same_as_pil(_arith_jpeg(40, 33, factors, coefs, **kw))


def _lossless_jpeg(img, psv, pt=0, restart_rows=0, interleaved=True, jfif=False):
    """A lossless JPEG (SOF3) of 8-bit samples (h, w, n): predictor psv,
    point transform pt, differences Huffman-coded with one table built from
    their category counts (categories 0-16)."""
    h, w, n = img.shape
    x = (img.astype(np.int64) >> pt)
    diffs = np.zeros_like(x)
    for c in range(n):
        p = x[..., c]
        for y in range(h):
            first = y == 0 or (restart_rows and y % restart_rows == 0)
            for xx in range(w):
                if first:
                    pred = (1 << (7 - pt)) if xx == 0 else p[y, xx - 1]
                elif xx == 0:
                    pred = p[y - 1, 0]
                else:
                    ra, rb, rc = p[y, xx - 1], p[y - 1, xx], p[y - 1, xx - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
                diffs[y, xx, c] = (p[y, xx] - pred) & 0xFFFF
    d = np.where(diffs >= 32768, diffs - 65536, diffs)
    cats = np.where(d == -32768, 16, np.ceil(np.log2(np.abs(d) + 1)).astype(np.int64))
    counts = np.bincount(cats.ravel(), minlength=17)
    symbols = sorted((s for s in range(17) if counts[s]), key=lambda s: -counts[s])
    bits = [0] * 16                      # the two most frequent in 2 bits, the rest in 6
    bits[1], bits[5] = min(2, len(symbols)), max(0, len(symbols) - 2)
    table = _codes(bits, symbols)

    def put(code, nbits, out):
        out.extend((code >> (nbits - 1 - i)) & 1 for i in range(nbits))

    def code_rows(comps, rows):
        out = []
        for y in rows:
            for xx in range(w):
                for c in comps:
                    v = int(d[y, xx, c])
                    s = int(cats[y, xx, c])
                    put(*table[s], out)
                    if 0 < s < 16:
                        put(v if v >= 0 else v + (1 << s) - 1, s, out)
        out.extend([1] * (-len(out) % 8))
        b = bytes(int("".join(map(str, out[i:i + 8])), 2) for i in range(0, len(out), 8))
        return b.replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    head = b"\xff\xd8" + (seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
                            if jfif else b"")
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([n])
    sof += b"".join(bytes([c + 1, 0x11, 0]) for c in range(n))
    out = head + seg(0xC3, sof) + seg(0xC4, bytes([0x00] + bits) + bytes(symbols))
    if restart_rows:
        out += seg(0xDD, (restart_rows * w).to_bytes(2, "big"))
    for comps in ([list(range(n))] if interleaved else [[c] for c in range(n)]):
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                   + bytes([psv, 0, pt]))
        blocks = [range(y, min(h, y + restart_rows)) for y in range(0, h, restart_rows)] \
            if restart_rows else [range(h)]
        for i, rows in enumerate(blocks):
            out += code_rows(comps, rows)
            if i < len(blocks) - 1:
                out += bytes([0xFF, 0xD0 + i % 8])
    return out + b"\xff\xd9"


@pytest.mark.parametrize("kind", ["sof9", "sof10", "sof3"])
@pytest.mark.parametrize("cut", [0.3, 0.8, 0.99])
def test_arithmetic_and_lossless_cut_short_raise(kind, cut):
    base = _jpeg(_photo(40, 48, seed=13), quality=85)
    data = _lossless_jpeg(_photo(17, 23, seed=13), 4) if kind == "sof3" else arith_version(
        base, progressive=kind == "sof10")
    with pytest.raises(OSError):
        _pil_rgb(data[:int(len(data) * cut)])
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data[:int(len(data) * cut)])


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("layout", ["grey", "ids 1, 2, 3", "jfif", "planar scans"])
def test_lossless_decodes_like_pil(psv, layout):
    img = _photo(19, 23, seed=psv)
    if layout == "grey":
        img = img[..., :1]
    data = _lossless_jpeg(img, psv, jfif=layout == "jfif", interleaved=layout != "planar scans")
    if layout == "jfif":     # YCbCr samples: libjpeg-turbo converts no colour in lossless mode
        with pytest.raises(OSError):
            _pil_rgb(data)
        with pytest.raises(ValueError, match="refused by PIL too"):
            decode_jpeg(data)
        return
    _same_as_pil(data)


@pytest.mark.parametrize("kw", [dict(pt=2), dict(restart_rows=4), dict(pt=1, restart_rows=5)],
                         ids=str)
@pytest.mark.parametrize("size", [(1, 1), (17, 23), (37, 29)], ids=str)
def test_lossless_point_transform_and_restarts(kw, size):
    _same_as_pil(_lossless_jpeg(_photo(*size, seed=40), 4, **kw))


# -- refusals and truncation ----------------------------------------------------------

def _patched(fn):
    data = bytearray(_jpeg(_photo(16, 16, seed=8)))
    return bytes(fn(data, data.index(b"\xff\xc0")))


def _insert_segment(marker, body=b"\x00\x00"):
    def fn(d, i):
        return d[:i] + bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body + d[i:]
    return fn


@pytest.mark.parametrize("name,fn,match", [
    ("sof11", lambda d, i: d[:i + 1] + b"\xcb" + d[i + 2:], "lossless arithmetic-coded"),
    ("sof13", lambda d, i: d[:i + 1] + b"\xcd" + d[i + 2:], "hierarchical arithmetic-coded"),
    ("sof15", lambda d, i: d[:i + 1] + b"\xcf" + d[i + 2:], "hierarchical arithmetic-coded"),
    ("sof3, subsampled", lambda d, i: d[:i + 1] + b"\xc3" + d[i + 2:], "lossless JPEG with sub"),
    ("12-bit", lambda d, i: d[:i + 4] + b"\x0c" + d[i + 5:], "12-bit precision"),
    ("dac of table 32", _insert_segment(0xCC, b"\x20\x10"), "corrupt DAC"),
    ("sof5", lambda d, i: d[:i + 1] + b"\xc5" + d[i + 2:], "hierarchical"),
    ("sof7", lambda d, i: d[:i + 1] + b"\xc7" + d[i + 2:], "hierarchical"),
    ("dhp", _insert_segment(0xDE), "hierarchical"),
])
def test_refused_kinds_name_their_feature(name, fn, match):
    """Each refusal names the feature; PIL refuses these files too."""
    data = _patched(fn)
    with pytest.raises(ValueError, match=match) as e:
        decode_jpeg(data)
    if "refuses" in str(e.value) or "corrupt" in str(e.value):
        with pytest.raises(OSError):
            _pil_rgb(data)


def _adobe(data, transform):
    """The file with its Adobe segment's transform set to `transform`, or
    without the segment (None)."""
    i = data.index(b"\xff\xee")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    if transform is None:
        return data[:i] + data[i + 2 + n:]
    return data[:i + 15] + bytes([transform]) + data[i + 16:]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("adobe", ["cmyk", "ycck", "transform 1", "no adobe segment"])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_cmyk_and_ycck_decode_like_pil(adobe, progressive, subsampling):
    """PIL writes CMYK with an Adobe segment of transform 0; the same
    coefficients under transform 2 (or 1, which libjpeg also takes as YCCK)
    are YCCK, and without the segment CMYK again."""
    buf = io.BytesIO()
    Image.fromarray(_photo(37, 53, seed=9)).convert("CMYK").save(
        buf, format="JPEG", quality=85, progressive=progressive, subsampling=subsampling)
    data = buf.getvalue()
    assert data[data.index(b"Adobe") + 11] == 0
    data = _adobe(data, {"cmyk": 0, "ycck": 2, "transform 1": 1, "no adobe segment": None}[adobe])
    _same_as_pil(data)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("cut", [0.1, 0.5, 0.9, 0.999])
def test_a_file_cut_short_raises(progressive, cut):
    data = _jpeg(_photo(40, 48, seed=10), progressive=progressive)
    with pytest.raises(OSError):
        _pil_rgb(data[:int(len(data) * cut)])
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data[:int(len(data) * cut)])


def test_corrupt_data_raises():
    with pytest.raises(ValueError):
        decode_jpeg(b"\xff\xd8\xff\xc4\x00\x04\x00\x01\xff\xd9")
    with pytest.raises(ValueError):
        decode_jpeg(b"\xff\xd8")
    with pytest.raises(ValueError):
        decode_jpeg(b"not a jpeg")


# -- the loader on JPEG trees ---------------------------------------------------------

@pytest.mark.parametrize("image_size", [16, 64])
def test_decode_resize_and_original_equal_jax(tmp_path, image_size):
    path = str(tmp_path / "img.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg(_photo(45, 61, seed=11), quality=80))
    np.testing.assert_array_equal(decode_resize(path, image_size),
                                  j_decode_resize(path, image_size))
    np.testing.assert_array_equal(decode_original(path), j_decode_original(path))


def test_polarimetric_dataset_on_a_jpeg_tree_is_jaxs(tmp_path):
    """Five view folders of JPEGs (and a GIF): the batches equal the JAX
    loader's bit for bit, cached and not, shuffled and split."""
    rng = np.random.default_rng(12)
    for d in ("I0", "I45", "I90", "I135", "ED"):
        os.makedirs(tmp_path / d)
        for i in range(6):
            views, diffuse, _ = synth_polar_scene(rng, 40, 40)
            img = (np.clip(camera_image(diffuse, views), 0, 1) * 255).astype(np.uint8)
            name = tmp_path / d / f"img_{i:05d}.{'gif' if i == 5 else 'jpg'}"
            Image.fromarray(img).save(name, quality=70 + 5 * i, progressive=i % 2 == 1)
    for cache in (True, False):
        cfg = DataConfig(data_dir=str(tmp_path), cache_in_memory=cache)
        jcfg = JDataConfig(data_dir=str(tmp_path), cache_in_memory=cache)
        mine = PolarimetricDataset(cfg, 32, 2, num_workers=2)
        theirs = JPolarimetricDataset(jcfg, 32, 2, num_workers=2)
        for args in ((None,), (3, 1, 2)):
            got, want = list(mine.iter_epoch(*args)), list(theirs.iter_epoch(*args))
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
