"""The port's HTTP front end (serve_http.py) and CLI (cli.py, config.py's
from_args) on the CPU: a live server answers each endpoint and status code
as tests/test_serve_http.py expects of the JAX package's, the batching window
joins concurrent requests, and the CLI parses the JAX flag set into the same
fields. Every socket call has a timeout; every server is shut down in a
finally or a fixture's teardown."""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu_torch import Config
from shmgan_tpu_torch import cli
from shmgan_tpu_torch.checkpoint import export_inference_bundle
from shmgan_tpu_torch.data.codecs import resize_bilinear
from shmgan_tpu_torch.data.loader import to_unit
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.serve import BatchInferenceEngine
from shmgan_tpu_torch.serve_http import HTTP_OUTPUTS, _decode_request_image, make_server

TIMEOUT = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(native=False):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=32, filter_size=8,
                                    specseg_base_filters=4, compute_dtype="float32")
    cfg.eval.native_resolution = native
    return cfg


def png_bytes(h=32, w=32, seed=0):
    arr = (np.random.default_rng(seed).uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _image(body):
    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im)


class _Running:
    """A server on a free port, served by a thread; shut down on exit."""

    def __init__(self, cfg, **kw):
        gen, _, specseg = build_models(cfg, device="cpu", seed=0)
        self.models = (gen, specseg)
        self.srv = make_server(cfg, gen, specseg, device="cpu", **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def running():
    run = _Running(tiny_cfg())
    with run as url:
        yield url, run


@pytest.fixture(scope="module")
def server(running):
    return running[0]


def test_healthz(server):
    payload = _get_json(server + "/healthz")
    assert payload["status"] == "ok" and payload["backend"] == "cpu"
    assert payload["devices"] >= 1


def test_specfree_image_equals_the_engine(running):
    """The default response is the calibrated output of the same decoded
    input, truncated to 8 bits."""
    url, run = running
    body = png_bytes(seed=1)
    with _post(url + "/v1/specfree", body) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        got = _image(r.read())
    eng = BatchInferenceEngine(tiny_cfg(), *run.models, batch_size=1, outputs=HTTP_OUTPUTS,
                               device="cpu")
    want = eng.process_images(_decode_request_image(body, 32))["gen_rgb_calibrated"][0]
    eng.close()
    np.testing.assert_array_equal(got, (np.clip(want, 0, 1) * 255).astype(np.uint8))


def test_specfree_mask_composited_and_json(server):
    with _post(server + "/v1/specfree?output=mask", png_bytes(seed=2)) as r:
        assert _image(r.read()).shape == (32, 32)
    with _post(server + "/v1/specfree?output=composited", png_bytes(seed=2)) as r:
        assert _image(r.read()).shape == (32, 32, 3)
    with _post(server + "/v1/specfree?output=json", png_bytes(seed=3)) as r:
        assert r.headers["Content-Type"] == "application/json"
        payload = json.loads(r.read())
    assert 0.0 <= payload["mask_coverage"] <= 1.0 and payload["size"] == 32
    assert _image(base64.b64decode(payload["image_png_b64"])).shape == (32, 32, 3)
    assert _image(base64.b64decode(payload["mask_png_b64"])).shape == (32, 32)


@pytest.mark.parametrize("query,body", [
    ("", b"this is not an image"), ("", b""), ("?size=17", None), ("?size=8", None),
    ("?size=4096", None), ("?size=-32", None), ("?size=narive", None), ("?output=gif", None),
    ("?size=native", "wide")])
def test_bad_requests_are_400(server, query, body):
    if body is None:
        body = png_bytes()
    elif body == "wide":
        body = png_bytes(16, 2064, seed=4)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server + "/v1/specfree" + query, body)
    assert exc.value.code == 400
    assert "error" in json.loads(exc.value.read())


def test_jpeg_is_400_with_a_reason(server):
    """A JPEG of a kind the port does not decode (hierarchical, SOF5, which
    PIL refuses too) is refused with the feature named."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, format="JPEG")
    data = bytearray(buf.getvalue())
    data[data.index(b"\xff\xc0") + 1] = 0xC5
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server + "/v1/specfree", bytes(data))
    error = json.loads(exc.value.read())["error"]
    assert exc.value.code == 400 and "JPEG" in error and "hierarchical" in error


def _photo_body(arr, fmt):
    """arr (h, w, 3) uint8 encoded as `fmt`: a PIL format name, "CMYK JPEG",
    "TIFF" (LZW), "P3" (an ASCII PPM), "ARITH JPEG" (PIL's JPEG re-coded
    arithmetically), "YCBCR JPEG TIFF" (JPEG-in-TIFF, 4:2:0, its tables in
    JPEGTables), "FLOAT TIFF" (the luma as 32-bit float samples), "JP2" (9/7,
    three layers) or "J2K" (a raw 5/3 codestream with the colour transform)."""
    from test_torch_jpeg import arith_version
    from test_torch_tiff import _jpeg_in_tiff

    if fmt == "P3":
        h, w, _ = arr.shape
        return b"P3\n%d %d\n255\n" % (w, h) + b" ".join(b"%d" % v for v in arr.ravel())
    if fmt == "ARITH JPEG":
        return arith_version(_photo_body(arr, "JPEG"))
    if fmt == "YCBCR JPEG TIFF":
        return _jpeg_in_tiff(arr, (2, 2), "strips", True)
    if fmt == "FLOAT TIFF":
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.float32) @ np.float32([0.3, 0.55, 0.15]) * 1.1 - 9).save(
            buf, format="TIFF", compression="tiff_adobe_deflate")
        return buf.getvalue()
    im = Image.fromarray(arr)
    kw = {"CMYK JPEG": dict(format="JPEG"), "TIFF": dict(format="TIFF", compression="tiff_lzw"),
          "WEBP": dict(format="WEBP", quality=80),
          "JP2": dict(format="JPEG2000", irreversible=True, quality_layers=[40, 15, 5]),
          "J2K": dict(format="JPEG2000", no_jp2=True, mct=1)}.get(fmt, dict(format=fmt))
    buf = io.BytesIO()
    (im.convert("CMYK") if fmt == "CMYK JPEG" else im).save(buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,query,shape", [("JPEG", "", (48, 40)), ("GIF", "", (48, 40)),
                                             ("JPEG", "?size=native", (40, 56)),
                                             ("WEBP", "", (48, 40)),
                                             ("WEBP", "?size=native", (40, 56)),
                                             ("TIFF", "", (48, 40)),
                                             ("CMYK JPEG", "?size=native", (40, 56)),
                                             ("P3", "", (40, 56)),
                                             ("ARITH JPEG", "", (48, 40)),
                                             ("ARITH JPEG", "?size=native", (40, 56)),
                                             ("YCBCR JPEG TIFF", "", (48, 40)),
                                             ("YCBCR JPEG TIFF", "?size=native", (40, 56)),
                                             ("FLOAT TIFF", "?size=native", (40, 56)),
                                             ("JP2", "", (48, 40)),
                                             ("JP2", "?size=native", (40, 56))])
def test_jpeg_and_gif_are_served_like_the_engine(running, fmt, query, shape):
    """A JPEG, GIF, WebP, TIFF, CMYK JPEG or ASCII PPM body gives 200,
    within one level of the engine given PIL's decoded pixels (resized as
    the server resizes)."""
    url, run = running
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    arr = np.stack([yy * 5, xx * 4, (yy + xx) * 3], -1).astype(np.uint8)
    body = _photo_body(arr, fmt)
    with _post(url + "/v1/specfree" + query, body) as r:
        assert r.status == 200
        got = _image(r.read())
    with Image.open(io.BytesIO(body)) as im:
        pixels = np.asarray(im.convert("RGB"))
    native = query == "?size=native"
    eng = BatchInferenceEngine(tiny_cfg(), *run.models, batch_size=1, outputs=HTTP_OUTPUTS,
                               native_resolution=native, device="cpu")
    if native:
        want = eng.process_images_native([to_unit(pixels)])[0]["gen_rgb_calibrated"]
    else:
        x = to_unit(resize_bilinear(pixels, (32, 32)))[None]
        want = eng.process_images(x)["gen_rgb_calibrated"][0]
    eng.close()
    want = (np.clip(want, 0, 1) * 255).astype(np.uint8)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("fmt", ["WEBP", "TIFF", "CMYK JPEG", "P3", "ARITH JPEG",
                                 "YCBCR JPEG TIFF", "FLOAT TIFF", "JP2", "J2K"])
@pytest.mark.parametrize("size", [256, "native"])
def test_request_decode_equals_jaxs_on_photo_formats(fmt, size):
    """serve_http._decode_request_image against the JAX package's (PIL's
    open, convert and BILINEAR resize), exactly."""
    from shmgan_tpu.serve_http import _decode_request_image as j_decode_request_image

    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:45, 0:61]
    arr = np.clip(np.stack([yy * 5, xx * 4, (yy + xx) * 3], -1) + rng.normal(0, 9, (45, 61, 3)),
                  0, 255).astype(np.uint8)
    body = _photo_body(arr, fmt)
    np.testing.assert_array_equal(_decode_request_image(body, size),
                                  j_decode_request_image(body, size))


def _htj2k_jp2():
    """A JP2 whose codestream declares HTJ2K with a CAP marker after SIZ
    (Pcap: Part 15). Its code-blocks are Part 1's, so PIL's openjpeg decodes
    it; the port refuses CAP by name."""
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(buf, format="JPEG2000")
    data = buf.getvalue()
    siz = data.index(b"\xff\x4f\xff\x51") + 2
    end = siz + 2 + int.from_bytes(data[siz + 2:siz + 4], "big")
    cap = b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"
    jp2c = data.index(b"jp2c") - 4                  # its box grows by the marker
    grown = (int.from_bytes(data[jp2c:jp2c + 4], "big") + len(cap)).to_bytes(4, "big")
    return data[:jp2c] + grown + data[jp2c + 4:end] + cap + data[end:]


@pytest.mark.parametrize("body,name,pil_rgb", [(b"8BPS" + bytes(40), "PSD", None),
                                               (_htj2k_jp2(), "HTJ2K", 90)],
                         ids=["psd", "jp2"])
def test_a_format_pil_opens_and_the_port_does_not_is_400_naming_it(server, body, name,
                                                                    pil_rgb):
    if pil_rgb is not None:
        assert (np.asarray(Image.open(io.BytesIO(body)).convert("RGB")) == pil_rgb).all()
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server + "/v1/specfree", body)
    assert exc.value.code == 400 and name in json.loads(exc.value.read())["error"]


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/v2/specfree")])
def test_unknown_path_404(server, method, path):
    with pytest.raises(urllib.error.HTTPError) as exc:
        if method == "GET":
            urllib.request.urlopen(server + path, timeout=TIMEOUT)
        else:
            _post(server + path, png_bytes())
    assert exc.value.code == 404


def test_stats_counts(server):
    with _post(server + "/v1/specfree", png_bytes(seed=5)) as r:
        assert r.status == 200
    payload = _get_json(server + "/stats")
    assert payload["requests"] >= 1 and payload["latency_ema_ms"] > 0
    assert payload["device_calls"] >= payload["requests"]
    assert payload["native_shape_budget"] == 8
    assert 0 <= payload["native_shapes"] <= payload["native_shape_budget"]
    # on the CPU the wrappers run the plain versions: no kernel launches
    assert set(payload["kernel_launches"]) >= {"instance_norm", "fused_standardize_yuv"}
    assert not any(payload["kernel_launches"].values())


def test_engine_pool_second_size_and_native(server):
    with _post(server + "/v1/specfree?size=16", png_bytes(48, 48, seed=6)) as r:
        assert _image(r.read()).shape == (16, 16, 3)
    with _post(server + "/v1/specfree?size=native", png_bytes(40, 56, seed=7)) as r:
        assert _image(r.read()).shape == (40, 56, 3)
    with _post(server + "/v1/specfree?size=native&output=mask", png_bytes(40, 56, seed=8)) as r:
        assert _image(r.read()).shape == (40, 56)
    sizes = _get_json(server + "/healthz")["compiled_sizes"]
    assert 16 in sizes and 32 in sizes and "native" in sizes


def test_native_default_via_config():
    with _Running(tiny_cfg(native=True)) as url:
        with _post(url + "/v1/specfree", png_bytes(24, 48, seed=9)) as r:
            assert _image(r.read()).shape == (24, 48, 3)
        with _post(url + "/v1/specfree?size=32", png_bytes(seed=10)) as r:
            assert _image(r.read()).shape == (32, 32, 3)


def test_native_shape_budget():
    """The second distinct bucket is refused with 400 at max_native_shapes=1;
    the first stays served."""
    with _Running(tiny_cfg(), max_native_shapes=1) as url:
        with _post(url + "/v1/specfree?size=native", png_bytes(40, 56, seed=11)) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url + "/v1/specfree?size=native", png_bytes(100, 130, seed=12))
        assert exc.value.code == 400
        with _post(url + "/v1/specfree?size=native", png_bytes(30, 60, seed=13)) as r:
            assert r.status == 200   # same 64x64 bucket
        assert _get_json(url + "/stats")["native_shapes"] == 1


def test_batching_window_joins_concurrent_requests():
    with _Running(tiny_cfg(), batch_size=4, batch_window_ms=200.0) as url:
        with _post(url + "/v1/specfree", png_bytes(seed=14)) as r:
            assert r.status == 200
        before = _get_json(url + "/stats")["device_calls"]

        def one(i):
            with _post(url + "/v1/specfree", png_bytes(seed=100 + i)) as r:
                return _image(r.read()).shape

        with ThreadPoolExecutor(max_workers=8) as ex:
            shapes = list(ex.map(one, range(8)))
        assert shapes == [(32, 32, 3)] * 8
        calls = _get_json(url + "/stats")["device_calls"] - before
        assert 2 <= calls < 8


def test_warm_sizes_build_engines_before_traffic():
    with _Running(tiny_cfg(), warm_sizes=(16, "native"), warm_native_buckets=[(40, 56)]) as url:
        assert sorted(_get_json(url + "/healthz")["compiled_sizes"], key=str) == [16, "native"]
        assert _get_json(url + "/stats")["native_shapes"] == 1


# -- the CLI -------------------------------------------------------------------

ARGVS = [
    [],
    ["--mode", "serve", "--serve_weights_bundle", "b.msgpack", "--serve_port", "9001",
     "--serve_batch_size", "8", "--serve_batch_window_ms", "20", "--serve_warm_sizes",
     "native, 128", "--native_resolution", "true", "--compute_dtype", "float32",
     "--mask_chroma_prior", "yes", "--serve_watch_dir", "in", "--result_dir", "out"],
    ["--mode", "train", "--image_size", "256", "--batch_size", "4", "--filter_size", "32",
     "--g_lr", "1e-4", "--remat", "gen", "--seed", "3", "--flip", "false", "--psd_naming", "1",
     "--data_parallel", "2", "--upsample_mode", "resize_conv", "--specseg_in_channels", "2",
     "--export_dtype", "float16", "--checkpoint_step", "7", "--use_ema", "false"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "serve", "train"])
def test_cli_parses_the_jax_flag_set(argv):
    got, want = Config.from_args(argv), JConfig.from_args(argv)
    assert got.mode == want.mode
    for section in ("model", "train", "data", "mesh", "eval", "serve"):
        for f in dataclasses.fields(getattr(got, section)):
            assert getattr(getattr(got, section), f.name) == \
                getattr(getattr(want, section), f.name), f"{section}.{f.name}"
    assert set(got.describe().splitlines()) <= set(want.describe().splitlines())


SMALL = ["--image_size", "32", "--filter_size", "4"]


@pytest.mark.parametrize("mode", ["train", "test", "export", "bench"])
def test_cli_modes_not_ported_raise(mode, tmp_path, monkeypatch):
    """Only --mode bench is still not ported: it raises, naming its ROADMAP
    item. train, test and export run now (tests/test_torch_cli_train.py);
    from a directory without a dataset, train and test raise on the missing
    folder and export writes the bundle of the seed's random weights, as the
    JAX package's do."""
    monkeypatch.chdir(tmp_path)
    if mode == "bench":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["--mode", mode], device="cpu")
    elif mode == "export":
        cli.main(["--mode", mode] + SMALL, device="cpu")
        with open(tmp_path / "models" / "shmgan_infer.msgpack.json") as f:
            assert json.load(f)["step"] == 0
    else:
        with pytest.raises(FileNotFoundError, match="data"):
            cli.main(["--mode", mode] + SMALL, device="cpu")


def test_cli_serve_needs_a_bundle(tmp_path):
    """Without --serve_weights_bundle the weights come from the train
    checkpoint (before training was ported this raised): G is the
    checkpoint's, not the seed's."""
    from shmgan_tpu_torch.checkpoint import CheckpointManager
    from shmgan_tpu_torch.train.state import create_train_state

    argv = ["--mode", "serve", "--checkpoint_save_dir", str(tmp_path)] + SMALL
    cfg = Config.from_args(argv)
    state = create_train_state(cfg, build_models(cfg, device="cpu", seed=5))
    state.step = 4
    CheckpointManager(str(tmp_path)).save(state)
    gen, _ = cli.serving_models(Config.from_args(argv), device="cpu")
    for (n, p), q in zip(gen.named_parameters(), state.gen.parameters()):
        assert torch.equal(p, q), n


def test_cli_loads_the_bundle_and_its_header(tmp_path):
    cfg = tiny_cfg()
    cfg.model = dataclasses.replace(cfg.model, specseg_in_channels=2,
                                    upsample_mode="resize_conv")
    gen, _, specseg = build_models(cfg, device="cpu", seed=1)
    path = str(tmp_path / "b.msgpack")
    export_inference_bundle(gen, specseg, cfg, path, 3)
    served = Config.from_args(["--mode", "serve", "--serve_weights_bundle", path])
    g2, s2 = cli.serving_models(served, device="cpu")
    assert (served.model.filter_size, served.model.specseg_in_channels,
            served.model.upsample_mode) == (8, 2, "resize_conv")
    for a, b in ((gen, g2), (specseg, s2)):
        for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), n
