"""HTTP serving over the batch inference engine, in the standard library:
the counterpart of shmgan_tpu/serve_http.py, with the same endpoints, query
parameters, status codes and JSON keys.

Endpoints:
  GET  /healthz                   liveness and device (JSON)
  GET  /stats                     request counters, latency EMA, device calls,
                                  native-shape budget, the port's kernel
                                  launches in this process (JSON)
  POST /v1/specfree               body: an encoded image in any format
                                  data/codecs.decode reads (PNG, JPEG incl.
                                  CMYK/YCCK, GIF, WebP lossy/lossless/
                                  animated, TIFF, JPEG 2000 (JP2 or a raw
                                  codestream), PNM P1-P6, BMP),
                                  told by its bytes, as JAX's PIL tells it
       ?size=<px>|native          a square resize to <px> (a multiple of 16 in
                                  [16, 2048]; default cfg.model.image_size, or
                                  native with cfg.eval.native_resolution), or
                                  the photo's own (h, w), reflect-padded to a
                                  bucket and cropped back
       ?output=image|composited|mask|json
                                  the calibrated PNG (default), the
                                  mask-composited PNG, the mask PNG, or JSON
                                  with both PNGs base64-encoded
  400 for a bad request (body, size, output, an image that is truncated,
  corrupt, of a kind PIL does not read either, or of one PIL reads and the
  port does not, named in the body: AVIF, PSD, TGA, HTJ2K, ...; the
  native-shape budget spent), 404 for an unknown path, 500 when inference
  fails.

One device, many request threads: decode and encode run on the request
threads, every device call (warm-ups included) under EnginePool.device_lock.
That lock also keeps infer.ieee_f32's process-wide TF32 flags to one thread
at a time.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.data.codecs import decode, resize_bilinear
from shmgan_tpu_torch.data.loader import to_unit
from shmgan_tpu_torch.infer import bucket_shape, pad_to_bucket
from shmgan_tpu_torch.ops.kernels import launch_counts
from shmgan_tpu_torch.serve import BatchInferenceEngine, png_bytes

# the outputs the handler reads; the engines compute nothing else
HTTP_OUTPUTS = ("gen_rgb_calibrated", "gen_rgb_composited", "mask")


class EnginePool:
    """One BatchInferenceEngine per image size (or "native"), built on first
    use over the same modules. Device calls go through `device_lock`."""

    def __init__(self, cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                 batch_size: int = 1, max_sizes: int = 4, device: str = "cuda"):
        self._cfg = cfg
        self._gen = gen
        self._specseg = specseg
        self._batch_size = batch_size
        self._max_sizes = max_sizes
        self._device = device
        self._engines: Dict[object, BatchInferenceEngine] = {}
        self._build_lock = threading.Lock()
        self.device_lock = threading.Lock()

    @property
    def sizes(self) -> list:
        return sorted(self._engines, key=str)

    def engine(self, size) -> BatchInferenceEngine:
        """size: a square side (int), or "native" for the engine that serves
        every photo at its own resolution."""
        eng = self._engines.get(size)
        if eng is not None:
            return eng
        with self._build_lock:
            eng = self._engines.get(size)
            if eng is None:
                if len(self._engines) >= self._max_sizes:
                    raise ValueError(f"engine pool limit ({self._max_sizes} sizes) reached")
                cfg = dataclasses.replace(self._cfg)
                kw = dict(batch_size=self._batch_size, outputs=HTTP_OUTPUTS,
                          data_parallel=self._cfg.mesh.data_parallel, device=self._device)
                if size == "native":
                    eng = BatchInferenceEngine(cfg, self._gen, self._specseg,
                                               native_resolution=True, **kw)
                else:
                    cfg.model = dataclasses.replace(self._cfg.model, image_size=size)
                    eng = BatchInferenceEngine(cfg, self._gen, self._specseg, **kw)
                self._engines[size] = eng
        return eng

    def warm(self, sizes) -> None:
        """Build and warm one engine per size before traffic."""
        for size in sizes:
            eng = self.engine(size if size == "native" else int(size))
            with self.device_lock:
                eng.warmup()

    def warm_native(self, buckets) -> None:
        """Warm the native engine at each (h, w) bucket before traffic."""
        eng = self.engine("native")
        for h, w in buckets:
            with self.device_lock:
                eng.process_images_native([np.zeros((h, w, 3), np.float32)])


def _decode_request_image(body: bytes, size) -> np.ndarray:
    """(1, h, w, 3) float32 in [0, 1]: resized to (size, size) as PIL's
    BILINEAR does, or at its own (h, w) for size "native" (both sides in
    [16, 2048])."""
    rgb = decode(body)
    h, w = rgb.shape[:2]
    if size == "native":
        if not (16 <= w <= 2048 and 16 <= h <= 2048):
            raise ValueError(f"native-size images must have both sides in [16, 2048], "
                             f"got {h}x{w}")
    elif (h, w) != (size, size):
        rgb = resize_bilinear(rgb, (size, size))
    return to_unit(rgb)[None]


class BatchingFrontend:
    """Aggregates concurrent requests of one image size (of one exact (h, w)
    for native) into single device calls: a collector thread per key waits
    up to window_s for more requests, bounded by max_batch, runs one call
    and hands each waiter its slice. With window_s == 0 each request is its
    own call."""

    def __init__(self, pool: EnginePool, window_s: float, max_batch: int):
        self._pool = pool
        self._window_s = window_s
        self._max_batch = max(1, max_batch)
        self._queues: Dict[object, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._calls_lock = threading.Lock()
        self._device_calls = 0

    @property
    def device_calls(self) -> int:
        with self._calls_lock:
            return self._device_calls

    def _count_device_call(self) -> None:
        with self._calls_lock:
            self._device_calls += 1

    @staticmethod
    def _run(eng: BatchInferenceEngine, rgb: np.ndarray, native: bool) -> Dict[str, np.ndarray]:
        """One device call; the images of `rgb` share one shape."""
        if native:
            outs = eng.process_images_native(list(rgb))
            return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
        return eng.process_images(rgb)

    def _collector(self, eng, native: bool, q: "queue.Queue") -> None:
        while True:
            batch = [q.get()]
            deadline = time.perf_counter() + self._window_s
            while len(batch) < self._max_batch:
                rest = deadline - time.perf_counter()
                if rest <= 0:
                    break
                try:
                    batch.append(q.get(timeout=rest))
                except queue.Empty:
                    break
            # a waiter that timed out is served by nobody: skip it
            batch = [item for item in batch if not item[1]["cancelled"].is_set()]
            if not batch:
                continue
            rgb = np.concatenate([item[0] for item in batch])
            try:
                with self._pool.device_lock:
                    self._count_device_call()
                    out = self._run(eng, rgb, native)
                i = 0
                for item in batch:
                    n = item[0].shape[0]
                    item[1]["out"] = {k: v[i:i + n] for k, v in out.items()}
                    i += n
            except Exception as e:  # the boundary: every waiter gets the failure
                for item in batch:
                    item[1]["err"] = e
            finally:
                for item in batch:
                    item[1]["done"].set()

    def submit(self, size, rgb: np.ndarray, timeout_s: float = 600.0) -> Dict[str, np.ndarray]:
        # the engine is built on the request thread, so a pool-limit error
        # is this request's, not the collector's
        native = size == "native"
        eng = self._pool.engine(size)
        if self._window_s <= 0:
            with self._pool.device_lock:
                self._count_device_call()
                return self._run(eng, rgb, native)
        key = ("native",) + rgb.shape[1:3] if native else size
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = queue.Queue()
                threading.Thread(target=self._collector, args=(eng, native, q),
                                 daemon=True).start()
        slot = {"done": threading.Event(), "cancelled": threading.Event()}
        q.put((rgb, slot))
        if not slot["done"].wait(timeout=timeout_s):
            slot["cancelled"].set()
            raise TimeoutError(f"inference timed out after {timeout_s}s")
        if "err" in slot:
            raise slot["err"]
        return slot["out"]


class _Server(ThreadingHTTPServer):
    # The standard library listens with a backlog of 5. A burst of
    # concurrent clients, which the batching window is there for, overflows
    # it, and each connection the kernel drops waits out TCP's 1 s SYN retry.
    request_queue_size = 128


def _device_info(device: str) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"backend": "cuda", "devices": torch.cuda.device_count(),
                "device_name": torch.cuda.get_device_name(dev)}
    return {"backend": dev.type, "devices": 1, "device_name": dev.type}


def make_server(cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                host: str = "127.0.0.1", port: int = 0, batch_size: int = 1,
                batch_window_ms: float = 0.0, warm_sizes=(), max_native_shapes: int = 8,
                warm_native_buckets=(), device: str = "cuda") -> ThreadingHTTPServer:
    """Build (not start) the server over G and SpecSeg on `device`. port=0
    binds a free port (server.server_address[1]). batch_window_ms > 0 turns
    on the batching window, each call bounded by batch_size. warm_sizes and
    warm_native_buckets warm engines before the server is returned.
    max_native_shapes bounds the distinct bucket shapes size=native may
    bring: a request that would add one more is refused with 400."""
    pool = EnginePool(cfg, gen, specseg, batch_size=batch_size, device=device)
    native_shapes: set = set()
    native_shapes_lock = threading.Lock()
    if warm_sizes:
        pool.warm(warm_sizes)
    if warm_native_buckets:
        buckets = {bucket_shape(int(h), int(w)) for h, w in warm_native_buckets}
        buckets = set(sorted(buckets)[:max_native_shapes])
        pool.warm_native(sorted(buckets))
        native_shapes |= buckets
    frontend = BatchingFrontend(pool, batch_window_ms / 1e3, batch_size)
    stats = {"requests": 0, "images": 0, "errors": 0, "latency_ema_ms": 0.0}
    stats_lock = threading.Lock()
    default_size = "native" if cfg.eval.native_resolution else cfg.model.image_size
    info = _device_info(device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _bytes(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict) -> None:
            self._bytes(code, json.dumps(payload).encode(), "application/json")

        def _error(self, code: int, e: Exception) -> None:
            with stats_lock:
                stats["errors"] += 1
            self._json(code, {"error": str(e)})

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", **info, "compiled_sizes": pool.sizes})
            elif path == "/stats":
                with stats_lock:
                    payload = dict(stats)
                payload["device_calls"] = frontend.device_calls
                with native_shapes_lock:
                    payload["native_shapes"] = len(native_shapes)
                    payload["native_shape_budget"] = max_native_shapes
                payload["kernel_launches"] = launch_counts()
                self._json(200, payload)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/specfree":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            q = parse_qs(url.query)
            t0 = time.perf_counter()
            try:
                size = q.get("size", [default_size])[0]
                if size != "native":
                    size = int(size)
                    if not (16 <= size <= 2048 and size % 16 == 0):
                        raise ValueError(f"size must be 'native' or a multiple of 16 in "
                                         f"[16, 2048], got {size}")
                output = q.get("output", ["image"])[0]
                if output not in ("image", "composited", "mask", "json"):
                    raise ValueError("output must be image|composited|mask|json")
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    raise ValueError("empty body")
                rgb = _decode_request_image(self.rfile.read(length), size)
                orig_hw = None
                if size == "native":
                    bs = bucket_shape(*rgb.shape[1:3])
                    with native_shapes_lock:
                        if bs not in native_shapes and len(native_shapes) >= max_native_shapes:
                            raise ValueError(
                                f"native-shape budget exhausted ({max_native_shapes} "
                                f"bucketed shapes); resize or pass an explicit ?size=")
                        native_shapes.add(bs)
                    # padded here, so that requests in one bucket share a shape
                    # and the batching window can join them
                    rgb, orig_hw = pad_to_bucket(rgb)
            except Exception as e:  # anything wrong with the request is a 400
                self._error(400, e)
                return
            try:
                out = frontend.submit(size, rgb)
            except Exception as e:  # the boundary: report, keep serving
                self._error(500, e)
                return
            if orig_hw is not None:
                oh, ow = orig_hw
                out = {k: v[:, :oh, :ow] for k, v in out.items()}

            gen = out["gen_rgb_calibrated"][0]
            mask = out["mask"][0, ..., 0]
            if output == "image":
                self._bytes(200, png_bytes(gen), "image/png")
            elif output == "composited":
                self._bytes(200, png_bytes(out["gen_rgb_composited"][0]), "image/png")
            elif output == "mask":
                self._bytes(200, png_bytes(mask), "image/png")
            else:
                self._json(200, {
                    "size": size,
                    "mask_coverage": round(float(mask.mean()), 5),
                    "image_png_b64": base64.b64encode(png_bytes(gen)).decode(),
                    "mask_png_b64": base64.b64encode(png_bytes(mask)).decode(),
                })
            dt_ms = (time.perf_counter() - t0) * 1e3
            with stats_lock:
                stats["requests"] += 1
                stats["images"] += 1
                ema = stats["latency_ema_ms"]
                stats["latency_ema_ms"] = round(
                    dt_ms if ema == 0.0 else 0.9 * ema + 0.1 * dt_ms, 2)

    return _Server((host, port), Handler)


def serve_forever(cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                  host: str = "0.0.0.0", port: int = 8000, batch_size: int = 1,
                  batch_window_ms: float = 0.0, warm_sizes=(), device: str = "cuda") -> None:
    srv = make_server(cfg, gen, specseg, host, port, batch_size,
                      batch_window_ms=batch_window_ms, warm_sizes=warm_sizes, device=device)
    print(f"[serve_http] listening on {srv.server_address}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
