"""The port's host batch decoder (csrc/host_loader.cc through
runtime/native_loader.py, built by runtime/build.py) against the JAX
package's (native/loader.cc through shmgan_tpu/runtime/native_loader.py,
built as tests/test_native.py builds it), on the CPU:

  - decode_batch on P5, P6, 24- and 32-bit BMP bottom-up and top-down and
    `.raw` blobs, downscaled 612x816 -> 128 and 100x150 -> 32, upscaled
    16 -> 32 and at the identity: within 1e-6 of JAX's, flags equal, and
    bit for bit its own plain numpy version;
  - every BMP and PNM of tests/data/torch_codecs/: the flags JAX's gives;
    p6_maxval100.ppm, accepted by both, is held to JAX's resize of PIL's
    scaled samples (the one deliberate difference: loader.cc copies them
    unscaled);
  - the refusals: truncated headers and rasters, absurd dimensions, 16-bit
    PPM, other magics, RLE, palette, 16-bit and BITFIELDS BMPs;
  - decode_resize_batch, PolarimetricDataset (cached and not), the
    SingleFolderDataset and the SHIQ triplets against JAX's at default
    settings, with `used_native_decode` equal: lists all PPM/PGM/BMP within
    1e-6, a list with one PNG bit for bit (the PIL path), a list with one
    refused BMP through the per-file path;
  - codecs.encode_png's bytes equal JAX's native encoder's.

The tolerance is 1e-6, not 0: JAX's library is built with -march=native,
and its compiler may contract the lerps into fused multiply-adds; the port
builds with -ffp-contract=off."""

import io
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.config import DataConfig as JDataConfig
from shmgan_tpu.data import loader as J
from shmgan_tpu.data import synthetic as j_synthetic
from shmgan_tpu.data.triplets import TripletDataset as JTripletDataset
from shmgan_tpu.runtime import native_loader as jnl
from shmgan_tpu_torch.config import DataConfig
from shmgan_tpu_torch.data import codecs
from shmgan_tpu_torch.data import loader as P
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.data.triplets import TripletDataset
from shmgan_tpu_torch.runtime import build
from shmgan_tpu_torch.runtime import native_loader as nl

TOL = 1e-6
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_codecs")


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert jnl.build_native(), "the JAX package's native library did not build"
    assert nl.native_available()


def _image(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _pnm(img, maxval=255, comment=False):
    magic = b"P6" if img.shape[2] == 3 else b"P5"
    note = b"\n# a comment\n" if comment else b"\n"
    return magic + note + b"%d %d\n%d\n" % (img.shape[1], img.shape[0], maxval) + img.tobytes()


def _bmp(img, bpp=24, top_down=False, compression=0, colors=0):
    """An uncompressed BITMAPINFOHEADER BMP of `img` (RGB), rows BGR(X)."""
    h, w, _ = img.shape
    src_c = bpp // 8
    stride = (w * src_c + 3) // 4 * 4
    px = np.zeros((h, w, src_c), np.uint8)
    px[..., :3] = img[..., ::-1]
    if src_c == 4:
        px[..., 3] = 255
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * src_c] = (px if top_down else px[::-1]).reshape(h, w * src_c)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, compression,
                       rows.size, 2835, 2835, colors, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()


def _raw(img):
    return struct.pack("<II", img.shape[0], img.shape[1]) + img.tobytes()


KINDS = {
    "p6": (".ppm", lambda img: _pnm(img)),
    "p6_comment": (".ppm", lambda img: _pnm(img, comment=True)),
    "p5": (".pgm", lambda img: _pnm(img[..., :1])),
    "bmp24": (".bmp", lambda img: _bmp(img)),
    "bmp24_top_down": (".bmp", lambda img: _bmp(img, top_down=True)),
    "bmp32": (".bmp", lambda img: _bmp(img, 32)),
    "bmp32_top_down": (".bmp", lambda img: _bmp(img, 32, top_down=True)),
    "raw": (".raw", _raw),
}
SIZES = {"612x816_to_128": (612, 816, 128), "100x150_to_32": (100, 150, 32),
         "16_to_32": (16, 16, 32), "identity_24": (24, 24, 24)}


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _three_ways(paths, size):
    """(port, flags), (plain, flags), (JAX, flags) of one batch."""
    return (nl.decode_batch(paths, size, num_threads=3), nl.decode_batch_plain(paths, size),
            jnl.decode_batch(paths, size, num_threads=3))


@pytest.mark.parametrize("size", SIZES.values(), ids=SIZES.keys())
@pytest.mark.parametrize("kind", KINDS)
def test_decode_batch_matches_jax_and_its_plain_version(tmp_path, kind, size):
    h, w, s = size
    ext, encode = KINDS[kind]
    paths = [_write(tmp_path, f"{kind}{i}{ext}", encode(_image(h, w, seed=i))) for i in range(2)]
    (got, ok), (plain, ok_plain), (want, ok_jax) = _three_ways(paths, s)
    assert ok.tolist() == ok_plain.tolist() == ok_jax.tolist() == [1, 1]
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for i in range(2):   # the one-image entry point, on the same samples
        img = nl.decode_file_plain(paths[i])
        one = nl.resize_normalize(img, s)
        np.testing.assert_array_equal(one, nl.resize_normalize_plain(img, s))
        np.testing.assert_array_equal(one, got[i])
        np.testing.assert_allclose(one, jnl.resize_normalize(img, s), rtol=0, atol=TOL)


def test_codec_fixtures_flags_match_jax():
    names = sorted(f for f in os.listdir(FIXTURES) if f.endswith((".bmp", ".ppm")))
    assert names == ["p3.ppm", "p6_16bit.ppm", "p6_maxval100.ppm", "palette.bmp", "rle8.bmp"]
    paths = [os.path.join(FIXTURES, f) for f in names]
    (got, ok), (plain, ok_plain), (want, ok_jax) = _three_ways(paths, 64)
    # the ASCII P3 is refused too: it goes to the per-file path, as JAX's goes to PIL
    assert ok.tolist() == ok_plain.tolist() == ok_jax.tolist() == [0, 0, 1, 0, 0]
    np.testing.assert_array_equal(got, plain)
    assert not got[[0, 1, 3, 4]].any() and not want[[0, 1, 3, 4]].any()
    with Image.open(paths[2]) as im:     # PIL scales maxval 100 to 255
        scaled = np.asarray(im.convert("RGB"))
    np.testing.assert_allclose(got[2], jnl.resize_normalize(scaled, 64), rtol=0, atol=TOL)
    assert np.abs(got[2] - want[2]).max() > 0.3      # JAX's reads 100 as 100/255


def _refused():
    img = _image(6, 5, seed=3)
    good_bmp = _bmp(img)
    return {
        "truncated_header.ppm": b"P6\n4 4\n255",
        "truncated_raster.ppm": _pnm(img)[:-1],
        "absurd_dims.ppm": b"P6\n99999999999 2\n255\n" + b"\0" * 32,
        "no_dims.ppm": b"P6\n#only a comment",
        "p6_16bit.ppm": b"P6\n5 6\n65535\n" + img.astype(">u2").tobytes(),
        "ascii_p3.ppm": b"P3\n1 1\n255\n1 2 3\n",
        "zero_width.ppm": b"P6\n0 2\n255\n",
        "png_named.ppm": codecs.encode_png(img),
        "rle8.bmp": good_bmp[:30] + struct.pack("<I", 1) + good_bmp[34:],
        "bitfields.bmp": good_bmp[:30] + struct.pack("<I", 3) + good_bmp[34:],
        "bmp16.bmp": good_bmp[:28] + struct.pack("<H", 16) + good_bmp[30:],
        "bmp8_palette.bmp": good_bmp[:28] + struct.pack("<H", 8) + good_bmp[30:],
        "truncated.bmp": good_bmp[:-3],
        "short_header.bmp": good_bmp[:53],
        "zero_height.bmp": good_bmp[:22] + struct.pack("<i", 0) + good_bmp[26:],
        "int_min_height.bmp": good_bmp[:22] + struct.pack("<i", -2**31) + good_bmp[26:],
        "truncated.raw": _raw(img)[:-1],
        "zero.raw": struct.pack("<II", 0, 5),
        "not_raw.bin": _raw(img),
        "empty.bmp": b"",
    }


def test_refusals_match_jax(tmp_path):
    refused = _refused()
    paths = [_write(tmp_path, name, data) for name, data in refused.items()]
    paths.append(str(tmp_path / "missing.ppm"))
    (got, ok), (plain, ok_plain), (want, ok_jax) = _three_ways(paths, 8)
    assert ok.tolist() == ok_plain.tolist() == ok_jax.tolist() == [0] * len(paths)
    assert not got.any() and not plain.any() and not want.any()
    assert all(nl.decode_file_plain(p) is None for p in paths)


@pytest.mark.parametrize("maxval", [1, 100, 254])
def test_pnm_below_255_scales_as_pil(tmp_path, maxval):
    """Accepted by both; the samples are PIL's, the resize JAX's native one."""
    img = _image(9, 11, seed=maxval) % (maxval + 1)
    img.flat[:3] = [0, maxval, maxval // 2]
    paths = [_write(tmp_path, "a.ppm", _pnm(img, maxval)),
             _write(tmp_path, "b.pgm", _pnm(img[..., :1], maxval))]
    (got, ok), (plain, _), (_, ok_jax) = _three_ways(paths, 7)
    assert ok.tolist() == ok_jax.tolist() == [1, 1]
    np.testing.assert_array_equal(got, plain)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            scaled = np.asarray(im.convert("RGB"))
        np.testing.assert_allclose(got[i], jnl.resize_normalize(scaled, 7), rtol=0, atol=TOL)


def test_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "broken.cc").write_text("int f( {\n")
    monkeypatch.setattr(build, "CSRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"broken\.cc.*error"):
        build.load("broken")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no-such-compiler-here"):
        build.load("broken")


def test_library_hash_covers_the_host_compiler(monkeypatch):
    """Another host compiler (or another version of it) names another
    library, so a .so that one compiler built is never loaded for another;
    the kernels' names do not depend on it."""
    kernel = next(n for n in build.sources() if build.source_path(n).suffix == ".cu")
    names = []
    for identity in ("g++ 13.2", "g++ 14.1"):
        monkeypatch.setattr(build, "_compiler_identity", lambda compiler, i=identity: i)
        names.append((build.library_path("host_loader"), build.library_path(kernel)))
    assert names[0][0] != names[1][0] and names[0][1] == names[1][1]


# -- the loader's routing ----------------------------------------------------------

def _lists(tmp_path):
    """Three lists of 48x40 images: all native, one PNG among them, one
    refused (palette) BMP among them."""
    native = [_write(tmp_path, f"n{i}.bmp", _bmp(_image(48, 40, seed=i))) for i in range(3)]
    native.append(_write(tmp_path, "n3.ppm", _pnm(_image(48, 40, seed=3))))
    native.append(_write(tmp_path, "n4.pgm", _pnm(_image(48, 40, 1, seed=4))))
    png = _write(tmp_path, "m.png", codecs.encode_png(_image(48, 40, seed=5)))
    with open(os.path.join(FIXTURES, "palette.bmp"), "rb") as f:
        palette = _write(tmp_path, "r.BMP", f.read())
    return {"native": native, "one_png": native[:2] + [png] + native[2:],
            "one_refused": native[:2] + [palette] + native[2:]}


@pytest.mark.parametrize("which", ["native", "one_png", "one_refused"])
def test_decode_resize_batch_matches_jax(tmp_path, which):
    paths = _lists(tmp_path)[which]
    want, used = J.decode_resize_batch(paths, 32, num_workers=2)
    got = P.decode_resize_batch(paths, 32, num_workers=2)
    _, got_used = P._decode_batch(paths, 32, 2, True)
    assert got_used == used == (which != "one_png")
    if which == "one_png":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if which == "one_refused":   # the refused file went through decode_resize alone
        np.testing.assert_array_equal(got[2], J.decode_resize(paths[2], 32))
    # allow_native=False: the PIL path, bit for bit with JAX's
    np.testing.assert_array_equal(P.decode_resize_batch(paths, 32, allow_native=False),
                                  J.decode_resize_batch(paths, 32, allow_native=False)[0])


@pytest.mark.parametrize("fmt", ["ppm", "bmp"])
def test_datasets_on_native_trees_match_jax(tmp_path, fmt):
    """write_fixture_tree(fmt=...) writes JAX's bytes; PolarimetricDataset
    cached and not, and SingleFolderDataset cached and not, against JAX's."""
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    synthetic.write_fixture_tree(port_root, 4, 40, seed=2, fmt=fmt)
    j_synthetic.write_fixture_tree(jax_root, 4, 40, seed=2, fmt=fmt)
    for d in ("I0", "ED"):
        for f in sorted(os.listdir(os.path.join(jax_root, d))):
            with open(os.path.join(jax_root, d, f), "rb") as a, \
                    open(os.path.join(port_root, d, f), "rb") as b:
                assert a.read() == b.read(), f
    for cache in (True, False):
        kw = dict(data_dir=port_root, cache_in_memory=cache)
        ds = P.PolarimetricDataset(DataConfig(**kw), image_size=32, batch_size=2)
        jds = J.PolarimetricDataset(JDataConfig(**kw), image_size=32, batch_size=2)
        for got, want in zip(ds.iter_epoch(shuffle_seed=3), jds.iter_epoch(shuffle_seed=3)):
            assert got.shape == want.shape == (5, 2, 32, 32, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert ds.used_native_decode is jds.used_native_decode is True
    folder = os.path.join(port_root, "I0")
    for cache in (True, False):
        ds = P.SingleFolderDataset(folder, 32, batch_size=3, cache=cache)
        jds = J.SingleFolderDataset(folder, 32, batch_size=3, cache=cache)
        assert ds.used_native_decode == jds.used_native_decode == cache
        for got, want in zip(ds, jds):
            if cache:
                np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            else:   # decode_resize file by file: PIL's semantics, bit for bit
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["folder", "shiq"])
def test_triplets_on_bmp_match_jax(tmp_path, layout):
    """A triplet tree with every PNG rewritten as a BMP: image and diffuse
    lists one call each, each mask file alone, against JAX's."""
    root = str(tmp_path / layout)
    j_synthetic.write_triplet_fixture_tree(root, 3, 40, seed=6, layout=layout)
    for d, _, files in os.walk(root):
        for f in files:
            png = os.path.join(d, f)
            with Image.open(png) as im:
                rgb = np.asarray(im.convert("RGB"))
            with open(png[:-4] + ".bmp", "wb") as out:
                out.write(codecs.encode_bmp(rgb))
            os.remove(png)
    for cache in (True, False):
        got = TripletDataset(root, 32, batch_size=3, cache_in_memory=cache)._load(np.arange(3))
        want = JTripletDataset(root, 32, batch_size=3, cache_in_memory=cache)._load(
            np.arange(3))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    shutil.rmtree(root)


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("channels", [1, 3])
def test_encode_png_bytes_match_jax_native(level, channels):
    img = _image(21, 34, channels, seed=level)
    assert codecs.encode_png(img, level) == jnl.encode_png(img, level)
    assert codecs.encode_png(img[..., 0], level) == jnl.encode_png(img[..., 0], level)


def test_encoders_write_pils_bytes():
    img = _image(7, 9, seed=8)
    for fmt, enc in (("PPM", codecs.encode_ppm), ("BMP", codecs.encode_bmp)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        assert enc(img) == buf.getvalue(), fmt
    buf = io.BytesIO()
    Image.fromarray(img[..., 0]).save(buf, format="PPM")
    assert codecs.encode_ppm(img[..., 0]) == buf.getvalue()
