"""The committed codec fixtures (tests/data/torch_codecs/), on the CPU: PIL
still decodes every fixture to its committed PNG, the port decodes every
fixture to the same pixels, exactly, and the directory says how it was
written. The 612x816 JPEG 2000 photo and the 16x16 4:2:0 sYCC JP2 of every
code-block style have no PNG beside them: PIL's pixels and the port's are
held to the SHA-256 written beside each."""

import hashlib
import os

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu_torch.data import codecs

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_codecs")
# a fixture is a file with its pixels beside it as <name>.png
FIXTURES = sorted(f for f in os.listdir(HERE) if os.path.isfile(os.path.join(HERE, f + ".png")))
PHOTO_JP2 = "photo_612x816.jp2"
STYLES_JP2 = "jp2_sycc420_styles.jp2"


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_every_fixture_has_its_pixels_and_the_set_is_whole():
    assert len(FIXTURES) == 52
    # and the README, the writer, the two JPEG 2000 files held to SHA-256s and those
    assert len(os.listdir(HERE)) == 2 * 52 + 6
    assert sum(os.path.getsize(os.path.join(HERE, f)) for f in os.listdir(HERE)) < 2_000_000


def _photo_sha256(name=PHOTO_JP2):
    with open(os.path.join(HERE, name + ".sha256")) as f:
        return f.read().strip()


def test_pil_still_decodes_the_jpeg2000_photo_to_its_sha256():
    path = os.path.join(HERE, PHOTO_JP2)
    assert os.path.getsize(path) <= 10_000
    with Image.open(path) as im:
        assert im.size == (816, 612)
        pixels = np.ascontiguousarray(im.convert("RGB"))
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == _photo_sha256()


def test_the_port_decodes_the_jpeg2000_photo_to_pils_sha256():
    with open(os.path.join(HERE, PHOTO_JP2), "rb") as f:
        got = codecs.decode(f.read())
    assert got.shape == (612, 816, 3) and got.dtype == np.uint8
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == _photo_sha256()


def test_pil_still_decodes_the_styles_jp2_to_its_sha256():
    path = os.path.join(HERE, STYLES_JP2)
    assert os.path.getsize(path) <= 1_000
    with Image.open(path) as im:
        assert im.size == (16, 16)
        pixels = np.ascontiguousarray(im.convert("RGB"))
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == _photo_sha256(STYLES_JP2)


def test_the_port_decodes_the_styles_jp2_to_pils_sha256():
    """4:2:0 sYCC, code-block styles 0x3f, SOP and EPH: what the SIZ and
    COD of the committed bytes say."""
    with open(os.path.join(HERE, STYLES_JP2), "rb") as f:
        data = f.read()
    cs = data[data.index(b"jp2c") + 4:]
    assert cs[42:51] == bytes([7, 1, 1, 7, 2, 2, 7, 2, 2])
    cod = cs.index(b"\xff\x52")
    assert cs[cod + 4] & 0x06 == 0x06 and cs[cod + 12] == 0x3F
    got = codecs.decode(data)
    assert got.shape == (16, 16, 3) and got.dtype == np.uint8
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == \
        _photo_sha256(STYLES_JP2)


@pytest.mark.parametrize("name", FIXTURES)
def test_pil_still_decodes_the_fixture_to_its_png(name):
    np.testing.assert_array_equal(_pil_rgb(os.path.join(HERE, name)),
                                  _pil_rgb(os.path.join(HERE, name + ".png")))


@pytest.mark.parametrize("name", FIXTURES)
def test_the_port_decodes_the_fixture_to_pils_pixels(name):
    with open(os.path.join(HERE, name), "rb") as f:
        got = codecs.decode(f.read())
    np.testing.assert_array_equal(got, _pil_rgb(os.path.join(HERE, name + ".png")))


def test_readme_says_how_the_fixtures_were_written():
    with open(os.path.join(HERE, "README.md")) as f:
        readme = f.read()
    assert "make_fixtures.py" in readme and "convert(\"RGB\")" in readme
    for kind in ("JPEG", "GIF", "PNG", "P6", "BMP", "JPEG 2000", PHOTO_JP2, STYLES_JP2):
        assert kind in readme
