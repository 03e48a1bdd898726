"""The host batch decoder: ctypes bindings of `csrc/host_loader.cc`, the
counterpart of shmgan_tpu/runtime/native_loader.py and its native/loader.cc.

  decode_batch(paths, image_size, num_threads=4) -> (batch, ok)
      PPM/PGM (maxval <= 255), uncompressed 24/32-bit BMP and `.raw` blobs
      decoded, resized (half-pixel bilinear, no antialiasing) and scaled to
      [0, 1] on a pool of C++ threads: (N, S, S, 3) float32 and (N,) uint8
      flags, a refused file's slot zero with flag 0.
  resize_normalize(img_u8, image_size)
      one decoded (H, W, C) uint8 image through the same resize. The data
      path does not call it: it keeps the JAX module's interface, and lets
      the tests hold the C++ resize alone against JAX's, apart from any
      decoder.

  estimate_diffuse_native(views)
      (V, ...) float32 -> the channel-wise minimum over the V views, the
      pseudo-diffuse estimate of a polarisation stack, in one C++ pass.

`data/loader.decode_resize_batch` sends a list here when every file is a
PPM, PGM or BMP, as the JAX package's loader does. The library is compiled
from the port's own source by runtime/build.py at first use (`$CXX` or g++);
a failed build raises, and nothing is loaded from the JAX package's native/.
The calls release the GIL. `calls` counts the library's calls.

`decode_batch_plain` and `resize_normalize_plain` are the same decoders and
the same float32 arithmetic in numpy, in the same order: the C++ repeats them
bit for bit (its build turns off floating-point contraction), and
`estimate_diffuse_plain` is numpy's minimum (the same values on finite
input). The tests and chip_smoke.py hold the library against them.

The JAX module's other function has a counterpart already: `encode_png` is
`data/codecs.encode_png` (the same filter-0 rows in one zlib stream).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
calls = 0  # calls into the library (decode_batch, resize_normalize, estimate_diffuse_native)

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from shmgan_tpu_torch.runtime.build import load

            lib = load("host_loader")
            lib.shm_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _F32P, _U8P, ctypes.c_int]
            lib.shm_decode_batch.restype = ctypes.c_int
            lib.shm_resize_normalize.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _F32P]
            lib.shm_resize_normalize.restype = None
            lib.shm_estimate_diffuse.argtypes = [_F32P, ctypes.c_int, ctypes.c_int64, _F32P]
            lib.shm_estimate_diffuse.restype = None
            _lib = lib
    return _lib


def native_available() -> bool:
    """Builds and loads the library: True, or the build's error raised."""
    _library()
    return True


def _count() -> None:
    global calls
    with _lock:
        calls += 1


def _check_size(image_size: int) -> None:
    if not 0 < image_size < 2**24:
        raise ValueError(f"image_size {image_size} is outside [1, 2^24)")


def _as_image(img_u8: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, C) uint8, C 1 or at least 3 -> contiguous (H, W, C)."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 samples, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] == 2 or min(img.shape) == 0 \
            or max(img.shape[:2]) > _INT_MAX:
        raise ValueError(f"expected (H, W) or (H, W, 1 | 3+), got {img_u8.shape}")
    return img


def decode_batch(paths: List[str], image_size: int,
                 num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, resize and scale `paths` in C++: ((N, S, S, 3) float32 in
    [0, 1], (N,) uint8 flags, 0 where a file was refused and its slot left
    zero)."""
    _check_size(image_size)
    encoded = [os.fsencode(p) for p in paths]
    if any(b"\0" in p for p in encoded):
        raise ValueError("a path holds a NUL byte")
    lib = _library()
    n = len(encoded)
    out = np.zeros((n, image_size, image_size, 3), np.float32)
    status = np.zeros((n,), np.uint8)
    names = (ctypes.c_char_p * n)(*encoded)
    lib.shm_decode_batch(names, n, image_size, image_size, out.ctypes.data_as(_F32P),
                         status.ctypes.data_as(_U8P), max(1, int(num_threads)))
    _count()
    return out, status


def resize_normalize(img_u8: np.ndarray, image_size: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (S, S, 3) float32 in [0, 1] through the C++ resize."""
    _check_size(image_size)
    img = _as_image(img_u8)
    h, w, c = img.shape
    out = np.zeros((image_size, image_size, 3), np.float32)
    _library().shm_resize_normalize(img.ctypes.data_as(_U8P), h, w, c, image_size,
                                    image_size, out.ctypes.data_as(_F32P))
    _count()
    return out


def estimate_diffuse_native(views: np.ndarray) -> np.ndarray:
    """(V, ...) float32 -> the channel-wise minimum over the V views, by the
    library. Raises RuntimeError("native library unavailable") when the
    library does not build or load, as the JAX function does."""
    try:
        lib = _library()
    except (RuntimeError, OSError) as e:
        raise RuntimeError("native library unavailable") from e
    views = np.ascontiguousarray(views, np.float32)
    if views.ndim < 1 or views.shape[0] == 0:
        raise ValueError(f"expected (V, ...) with V >= 1 views, got {views.shape}")
    out = np.empty(views.shape[1:], np.float32)
    lib.shm_estimate_diffuse(views.ctypes.data_as(_F32P), views.shape[0], out.size,
                             out.ctypes.data_as(_F32P))
    _count()
    return out


# -- the plain versions --------------------------------------------------------------

_C_SPACE = frozenset(b" \t\n\v\f\r")  # C's isspace
_INT_MAX = 2**31 - 1


def _decode_pnm_plain(b: bytes) -> Optional[np.ndarray]:
    channels = {ord("6"): 3, ord("5"): 1}.get(b[1], 0)
    if channels == 0:
        return None
    pos = 2

    def next_int() -> Optional[int]:
        nonlocal pos
        while pos < len(b):
            if b[pos] in _C_SPACE:
                pos += 1
            elif b[pos] == ord("#"):
                while pos < len(b) and b[pos] != ord("\n"):
                    pos += 1
            else:
                break
        v, any_digit = 0, False
        while pos < len(b) and ord("0") <= b[pos] <= ord("9"):
            v = v * 10 + b[pos] - ord("0")
            if v > 1 << 24:
                return None
            pos += 1
            any_digit = True
        return v if any_digit else None

    w, h, maxval = next_int(), None, None
    if w is not None:
        h = next_int()
    if h is not None:
        maxval = next_int()
    if maxval is None or not 0 < maxval <= 255 or w <= 0 or h <= 0:
        return None
    pos += 1  # the one whitespace byte after maxval
    need = w * h * channels
    if pos > len(b) or len(b) - pos < need:
        return None
    px = np.frombuffer(b, np.uint8, count=need, offset=pos).reshape(h, w, channels)
    if maxval != 255:  # PIL's scaling (the one deliberate difference from loader.cc)
        lut = np.minimum(np.round(np.arange(256) / maxval * 255), 255).astype(np.uint8)
        px = lut[px]
    return px


def _decode_bmp_plain(b: bytes) -> Optional[np.ndarray]:
    if len(b) < 54:
        return None
    data_off, = struct.unpack_from("<I", b, 10)
    w, h = struct.unpack_from("<ii", b, 18)
    bpp, = struct.unpack_from("<H", b, 28)
    compression, = struct.unpack_from("<I", b, 30)
    if compression != 0 or bpp not in (24, 32) or w <= 0 or h == 0:
        return None
    ah, src_c = abs(h), bpp // 8
    row_stride = (w * src_c + 3) // 4 * 4
    if len(b) < data_off + row_stride * ah:
        return None
    rows = np.frombuffer(b, np.uint8, count=row_stride * ah, offset=data_off)
    px = rows.reshape(ah, row_stride)[:, :w * src_c].reshape(ah, w, src_c)
    if h > 0:  # bottom-up
        px = px[::-1]
    return px[..., [2, 1, 0]]


def _decode_raw_plain(b: bytes) -> Optional[np.ndarray]:
    if len(b) < 8:
        return None
    h, w = struct.unpack_from("<II", b, 0)
    if h == 0 or w == 0 or h > _INT_MAX or w > _INT_MAX or len(b) - 8 < h * w * 3:
        return None
    return np.frombuffer(b, np.uint8, count=h * w * 3, offset=8).reshape(h, w, 3)


def decode_file_plain(path: str) -> Optional[np.ndarray]:
    """The decoders of host_loader.cc in numpy: (H, W, 1 | 3) uint8, or None
    for a file they refuse. By the magic bytes; a `.raw` blob by its name."""
    try:
        with open(path, "rb") as f:
            b = f.read()
    except OSError:
        return None
    if len(b) >= 2 and b[:1] == b"P":
        return _decode_pnm_plain(b)
    if b[:2] == b"BM":
        return _decode_bmp_plain(b)
    p = os.fsencode(path)
    dot = p.rfind(b".")
    if dot >= 0 and p[dot:] == b".raw":
        return _decode_raw_plain(b)
    return None


def resize_normalize_plain(img_u8: np.ndarray, image_size: int) -> np.ndarray:
    """host_loader.cc's ResizeNormalize in numpy, float32 operation for
    operation: fy = (y + 0.5) * sy - 0.5, clamp(floor), wy = clamp(fy - y0,
    0, 1), the two horizontal lerps, the vertical one, times 1/255."""
    _check_size(image_size)
    img = _as_image(img_u8)
    h, w, c = img.shape
    f32 = np.float32
    src = img.astype(f32)
    if c == 1:
        src = np.repeat(src, 3, axis=2)
    src = src[..., :3]

    def axis(n_in: int):
        s = f32(n_in) / f32(image_size)
        f = (np.arange(image_size).astype(f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.clip(np.floor(f).astype(np.int64), 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        wt = np.clip(f - i0.astype(f32), f32(0.0), f32(1.0))
        return i0, i1, wt

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    a, b = src[y0][:, x0], src[y0][:, x1]
    c_, d = src[y1][:, x0], src[y1][:, x1]
    top = a + (b - a) * wx
    bot = c_ + (d - c_) * wx
    return (top + (bot - top) * wy) * (f32(1.0) / f32(255.0))


def decode_batch_plain(paths: List[str], image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """decode_batch in numpy, one file after another."""
    _check_size(image_size)
    out = np.zeros((len(paths), image_size, image_size, 3), np.float32)
    status = np.zeros((len(paths),), np.uint8)
    for i, p in enumerate(paths):
        img = decode_file_plain(p)
        if img is not None:
            out[i] = resize_normalize_plain(img, image_size)
            status[i] = 1
    return out, status


def estimate_diffuse_plain(views: np.ndarray) -> np.ndarray:
    """estimate_diffuse_native in numpy: views.min(axis=0), in float32."""
    return np.asarray(views, np.float32).min(axis=0)
