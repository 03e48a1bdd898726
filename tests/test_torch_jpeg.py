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


# -- refusals and truncation ----------------------------------------------------------

def _patched(fn):
    data = bytearray(_jpeg(_photo(16, 16, seed=8)))
    return bytes(fn(data, data.index(b"\xff\xc0")))


def _insert_segment(marker, body=b"\x00\x00"):
    def fn(d, i):
        return d[:i] + bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body + d[i:]
    return fn


@pytest.mark.parametrize("name,fn,match", [
    ("sof9", lambda d, i: d[:i + 1] + b"\xc9" + d[i + 2:], "arithmetic coding"),
    ("sof10", lambda d, i: d[:i + 1] + b"\xca" + d[i + 2:], "arithmetic coding"),
    ("sof15", lambda d, i: d[:i + 1] + b"\xcf" + d[i + 2:], "arithmetic coding"),
    ("dac", _insert_segment(0xCC), "arithmetic coding"),
    ("12-bit", lambda d, i: d[:i + 4] + b"\x0c" + d[i + 5:], "12-bit precision"),
    ("sof3", lambda d, i: d[:i + 1] + b"\xc3" + d[i + 2:], "lossless"),
    ("sof5", lambda d, i: d[:i + 1] + b"\xc5" + d[i + 2:], "hierarchical"),
    ("sof7", lambda d, i: d[:i + 1] + b"\xc7" + d[i + 2:], "hierarchical"),
    ("dhp", _insert_segment(0xDE), "hierarchical"),
])
def test_refused_kinds_name_their_feature(name, fn, match):
    with pytest.raises(ValueError, match=match):
        decode_jpeg(_patched(fn))


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
