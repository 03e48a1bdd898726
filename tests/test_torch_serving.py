"""The port's serving pieces against the JAX package's on the CPU:
`make_infer_fn(outputs=...)`, native-resolution inference (bucket_shape,
pad_to_bucket, make_native_infer_fn) and make_mask_fn at float32, and the
engine's folder job and watch_folder against the JAX engine's on the same
files, PNGs and the photo formats (JPEG, GIF, 16-bit PNG, palette BMP,
16-bit PPM): the same files written, pixels within one level.

Both sides compute in float32; tolerances as tests/test_torch_infer.py: abs
1e-3 on the [0, 1] outputs, 1e-3 relative to the output's scale on the
others."""

import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.infer import bucket_shape as j_bucket_shape
from shmgan_tpu.infer import make_infer_fn as j_make_infer_fn
from shmgan_tpu.infer import make_mask_fn as j_make_mask_fn
from shmgan_tpu.infer import make_native_infer_fn as j_make_native_infer_fn
from shmgan_tpu.infer import pad_to_bucket as j_pad_to_bucket
from shmgan_tpu.serve import BatchInferenceEngine as JEngine
from shmgan_tpu.train.state import build_models as j_build_models
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import load_inference_weights
from shmgan_tpu_torch.infer import (OUTPUTS, bucket_shape, make_infer_fn, make_mask_fn,
                                    make_native_infer_fn, pad_to_bucket)
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.serve import BatchInferenceEngine

UNIT_RANGE = ("mask", "gen_rgb_calibrated", "gen_rgb_composited")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(tta=False, prior=False):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(
        jcfg.model, image_size=32, filter_size=8, specseg_base_filters=4,
        specseg_in_channels=2, upsample_mode="resize_conv", compute_dtype="float32")
    jcfg.eval = dataclasses.replace(jcfg.eval, mask_tta=tta, mask_chroma_prior=prior)
    cfg = Config()
    cfg.model = dataclasses.replace(
        cfg.model, image_size=32, filter_size=8, specseg_base_filters=4,
        specseg_in_channels=2, upsample_mode="resize_conv", compute_dtype="float32")
    cfg.eval.mask_tta, cfg.eval.mask_chroma_prior = tta, prior
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    """Seeded flax trees for every leaf of G and SpecSeg."""
    jcfg, _ = _configs()
    gen, _, specseg = j_build_models(jcfg)
    shapes = jax.eval_shape(lambda: (
        gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 10)), jnp.zeros((1, 32, 32, 1)))
        ["params"],
        specseg.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)), train=False)))
    rng = np.random.default_rng(21)

    def draw(tree, scale):
        flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
        out = {}
        for path, leaf in flat.items():
            v = rng.standard_normal(leaf.shape).astype(np.float32)
            out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                         1.0 + 0.1 * v if path[-1] == "scale" else scale * v)
        return flax.traverse_util.unflatten_dict(out)

    return draw(shapes[0], 0.1), draw(shapes[1], 0.2)


def _port(cfg, weights):
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, *weights)
    return gen, specseg


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def _close(got, want, key):
    want = np.asarray(want, np.float32)
    tol = 1e-3 if key in UNIT_RANGE else 1e-3 * max(1.0, np.abs(want).max())
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, atol=tol, err_msg=key)


@pytest.mark.parametrize("outputs", [
    ("mask",), ("gen_rgb_calibrated", "mask"), ("gen_rgb_calibrated", "gen_rgb_composited", "mask"),
    ("gen_y",), ("gen_rgb_denorm", "gen_rgb"), ("cyc_rgb", "mask"), OUTPUTS])
def test_outputs_subset_equals_the_full_call(weights, outputs):
    _, cfg = _configs()
    gen, specseg = _port(cfg, weights)
    rgb = torch.from_numpy(_images(2, 32, 32, seed=22))
    full = make_infer_fn(cfg, with_cyclic=True)(gen, specseg, rgb)
    # ("mask",) runs no G at all
    got = make_infer_fn(cfg, with_cyclic=True, outputs=outputs)(
        None if outputs == ("mask",) else gen, specseg, rgb)
    assert tuple(got) == outputs
    for k in outputs:
        assert torch.equal(got[k], full[k]), k


@pytest.mark.parametrize("outputs,with_cyclic", [(("bogus", "mask"), False), (("cyc_rgb",), False)])
def test_unknown_outputs_raise_as_jax(outputs, with_cyclic):
    jcfg, cfg = _configs()
    with pytest.raises(ValueError) as want:
        j_make_infer_fn(jcfg, with_cyclic=with_cyclic, outputs=outputs)
    with pytest.raises(ValueError) as got:
        make_infer_fn(cfg, with_cyclic=with_cyclic, outputs=outputs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("hw", [(40, 56), (64, 64), (20, 30), (70, 130)])
def test_bucket_and_pad_equal_jax(hw):
    assert bucket_shape(*hw) == j_bucket_shape(*hw)
    assert bucket_shape(*hw, bucket=32) == j_bucket_shape(*hw, bucket=32)
    rgb = _images(2, *hw, seed=23)
    got, got_hw = pad_to_bucket(rgb)
    want, want_hw = j_pad_to_bucket(rgb)
    assert got_hw == want_hw == hw
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        bucket_shape(*hw, bucket=40)


@pytest.mark.parametrize("hw", [(40, 56), (20, 30)], ids=["reflect", "edge-corner"])
def test_native_inference_matches_jax(weights, hw):
    jcfg, cfg = _configs(prior=True)
    rgb = _images(2, *hw, seed=24)
    want = j_make_native_infer_fn(jcfg)(*weights, rgb)
    gen, specseg = _port(cfg, weights)
    got = make_native_infer_fn(cfg)(gen, specseg, rgb)
    assert set(got) == set(want) == set(OUTPUTS)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("tta,prior", [(False, False), (True, True)])
def test_mask_fn_matches_jax(weights, tta, prior):
    jcfg, cfg = _configs()
    rgb = _images(2, 32, 48, seed=25)
    want = j_make_mask_fn(jcfg, tta=tta, prior=prior)(weights[1], jnp.asarray(rgb))
    _, specseg = _port(cfg, weights)
    got = make_mask_fn(cfg, tta=tta, prior=prior)(specseg, torch.from_numpy(rgb))
    _close(got.numpy(), want, "mask")


def test_native_engine_groups_pads_and_keeps_order(weights):
    _, cfg = _configs()
    gen, specseg = _port(cfg, weights)
    eng = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, native_resolution=True,
                               with_cyclic=True, device="cpu")
    rng = np.random.default_rng(26)
    sizes = [(40, 56), (32, 32), (40, 56), (24, 48), (40, 56)]
    imgs = [rng.uniform(0, 1, s + (3,)).astype(np.float32) for s in sizes]
    outs = eng.process_images_native(imgs)
    solo = eng.process_images_native([imgs[4]])[0]
    for img, out in zip(imgs, outs):
        assert out["gen_rgb_calibrated"].shape == img.shape
        assert out["mask"].shape == img.shape[:2] + (1,)
        assert out["cyc_rgb"].shape == (cfg.model.c_dim,) + img.shape
    for k in solo:
        np.testing.assert_allclose(outs[4][k], solo[k], rtol=1e-5, atol=1e-5, err_msg=k)
    eng.warmup()
    eng.close()


def test_engine_refusals(weights):
    _, cfg = _configs()
    gen, specseg = _port(cfg, weights)
    with pytest.raises(ValueError, match="batch_size 3 must divide data_parallel 2"):
        BatchInferenceEngine(cfg, gen, specseg, batch_size=3, data_parallel=2, device="cpu")
    square = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu")
    with pytest.raises(RuntimeError):
        square.process_images_native([np.zeros((32, 32, 3), np.float32)])
    square.warmup()
    square.close()


def _write_tree(root, sizes, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        arr = (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img{i}.png"))
    with open(os.path.join(root, "corrupt.png"), "wb") as f:
        f.write(b"not an image")


def _read_dir(path):
    out = {}
    for f in sorted(os.listdir(path)):
        with Image.open(os.path.join(path, f)) as im:
            out[f] = np.asarray(im).astype(np.int32)
    return out


@pytest.mark.parametrize("native", [False, True], ids=["square", "native"])
def test_folder_jobs_match_the_jax_engine(weights, tmp_path, native):
    """process_folder and watch_folder write the files the JAX engine's
    process_folder writes, pixels within one level; the corrupt file is
    skipped."""
    jcfg, cfg = _configs()
    in_dir = str(tmp_path / "in")
    _write_tree(in_dir, [(32, 32), (40, 56), (48, 40)], seed=27)
    kw = dict(batch_size=2, native_resolution=native, outputs=("gen_rgb_calibrated", "mask"))
    jeng = JEngine(jcfg, *weights, **kw)
    assert jeng.process_folder(in_dir, str(tmp_path / "jax")) == 3
    gen, specseg = _port(cfg, weights)
    eng = BatchInferenceEngine(cfg, gen, specseg, device="cpu", **kw)
    assert eng.process_folder(in_dir, str(tmp_path / "port")) == 3
    eng.watch_folder(in_dir, str(tmp_path / "watch"), poll_s=0.01, max_iterations=3)
    eng.close()
    want = _read_dir(str(tmp_path / "jax"))
    assert len(want) == 6
    for job in ("port", "watch"):
        got = _read_dir(str(tmp_path / job))
        assert list(got) == list(want)
        for f in want:
            assert got[f].shape == want[f].shape, f
            assert np.abs(got[f] - want[f]).max() <= 1, f


def _write_formats(root, seed):
    """A folder of the formats a camera or an editor writes (a WebP named
    .png among them: PIL, and the port, tell a file by its bytes), and a
    JPEG cut short (PIL refuses it too)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:40, 0:48]
    base = np.stack([yy * 6, xx * 5, (yy + xx) * 3], -1) + rng.normal(0, 6, (40, 48, 3))
    arr = np.clip(base, 0, 255).astype(np.uint8)
    im = Image.fromarray(arr)
    im.save(os.path.join(root, "a_baseline.jpg"), quality=85)
    im.save(os.path.join(root, "b_progressive.jpeg"), quality=85, progressive=True)
    im.quantize(64).save(os.path.join(root, "c_palette.gif"))
    im.quantize(64).save(os.path.join(root, "d_palette.bmp"))
    Image.fromarray((arr[..., 0].astype(np.uint16) << 4) | 3).save(
        os.path.join(root, "e_grey16.png"))
    with open(os.path.join(root, "f_16bit.ppm"), "wb") as f:
        f.write(b"P6\n48 40\n65535\n" + (arr.astype(">u2") * 257).tobytes())
    with open(os.path.join(root, "a_baseline.jpg"), "rb") as f:
        data = f.read()
    with open(os.path.join(root, "g_cut_short.jpg"), "wb") as f:
        f.write(data[:len(data) // 2])
    im.save(os.path.join(root, "h_webp_named.png"), format="WEBP", quality=80)
    im.convert("CMYK").save(os.path.join(root, "i_cmyk.jpg"), quality=85)
    with open(os.path.join(root, "j_ascii.ppm"), "wb") as f:
        f.write(b"P3\n48 40\n255\n" + b" ".join(b"%d" % v for v in arr.ravel()))
    from test_torch_jpeg import arith_version
    from test_torch_tiff import _jpeg_in_tiff
    with open(os.path.join(root, "k_arithmetic.jpg"), "wb") as f:
        f.write(arith_version(data))
    with open(os.path.join(root, "l_jpeg_in_tiff_named.png"), "wb") as f:
        f.write(_jpeg_in_tiff(arr, (2, 2), "strips", True))
    im.save(os.path.join(root, "m_jp2_named.png"), format="JPEG2000", irreversible=True,
            quality_layers=[30, 10])
    im.save(os.path.join(root, "n_not_listed.jp2"))     # JAX's extensions hold no .jp2


@pytest.mark.parametrize("native", [False, True], ids=["square", "native"])
def test_folder_jobs_on_photo_formats_match_the_jax_engine(weights, tmp_path, native):
    """JPEG, GIF, 16-bit PNG, palette BMP, 16-bit PPM, a .png-named WebP, a
    CMYK JPEG, an ASCII PPM, an arithmetic-coded JPEG, a .png-named
    YCbCr JPEG-in-TIFF and a .png-named JP2: the port's folder job writes
    the JAX engine's files, pixels within one level; the JPEG cut short is
    skipped by both, and the .jp2 is listed by neither."""
    jcfg, cfg = _configs()
    in_dir = str(tmp_path / "in")
    _write_formats(in_dir, seed=29)
    kw = dict(batch_size=2, native_resolution=native, outputs=("gen_rgb_calibrated", "mask"))
    jeng = JEngine(jcfg, *weights, **kw)
    assert jeng.process_folder(in_dir, str(tmp_path / "jax")) == 12
    gen, specseg = _port(cfg, weights)
    eng = BatchInferenceEngine(cfg, gen, specseg, device="cpu", **kw)
    assert eng.process_folder(in_dir, str(tmp_path / "port")) == 12
    eng.close()
    want, got = _read_dir(str(tmp_path / "jax")), _read_dir(str(tmp_path / "port"))
    assert len(want) == 24 and list(got) == list(want)
    for f in want:
        assert got[f].shape == want[f].shape, f
        assert np.abs(got[f] - want[f]).max() <= 1, f


def test_watch_folder_waits_for_a_stable_file_and_backs_off(weights, tmp_path, monkeypatch):
    _, cfg = _configs()
    gen, specseg = _port(cfg, weights)
    eng = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu")
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    _write_tree(in_dir, [(32, 32)], seed=28)
    sleeps = []
    monkeypatch.setattr("shmgan_tpu_torch.serve.time.sleep", sleeps.append)
    eng.watch_folder(in_dir, out_dir, poll_s=0.01, max_iterations=1)
    assert not os.path.exists(out_dir) and sleeps == [0.01]   # seen once: not stable yet
    eng.watch_folder(in_dir, out_dir, poll_s=0.01, max_iterations=5)
    assert sorted(os.listdir(out_dir)) == ["img0_mask.png", "img0_specfree.png"]
    # the corrupt file never decodes: every poll without work backs off
    assert len(sleeps) == 1 + 4
    eng.close()
