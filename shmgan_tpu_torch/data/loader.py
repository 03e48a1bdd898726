"""Image files in: the counterpart of shmgan_tpu/data/loader.py, to the same
float32 arrays, for every format the JAX package reads through PIL (the
extensions of `list_images`; each file decoded by its bytes, whatever its
name: PNG, JPEG, GIF, WebP, TIFF, PNM P1-P6, BMP).

  list_images, decode_resize, decode_original   one file, or a folder listed
  decode_resize_batch    a list of files, routed as the JAX loader routes it
  PolarimetricDataset    the five aligned views (I0, I45, I90, I135, ED, or
                         the PSD naming), batches of (V, B, H, W, 3)
  SingleFolderDataset    one flat RGB folder for inference, (B, H, W, 3)

Two decoders, chosen per list as JAX chooses them. A list whose every file
ends in .ppm, .pgm or .bmp goes to the host batch decoder
(runtime/native_loader.py, C++ threads): half-pixel bilinear without
antialiasing (the reference's keras/TF resize), times the f32 1/255. Each
file it refuses (RLE, palette or 16-bit BMP, maxval above 255, an ASCII
P3/P2 or a P1/P4 PNM, ...) then goes alone through `decode_resize`, as
JAX's goes to PIL. Any other list goes through a
thread pool of `decode_resize`: data/codecs.py's decoders (PIL's pixels) and
Pillow's BILINEAR, divided by 255, so a batch from a JPEG tree equals JAX's
bit for bit. A PNM of maxval below 255 is scaled to 8 bits as PIL scales it
on both routes, where JAX's native decoder copies its samples unscaled
(ROADMAP Queue 3, deliberate differences).

The five view folders are listed once and aligned by sorted file name; the
decoded views are cached in RAM as float32; the ED view is the channel-wise
minimum of the four polarised views when its folder is missing and
`est_diffuse` is set. The order of an epoch and each process's share of a
batch are the JAX package's. `used_native_decode` says whether the last
decode of a dataset took the host batch decoder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from shmgan_tpu_torch.config import DataConfig
from shmgan_tpu_torch.data.codecs import decode, resize_bilinear
from shmgan_tpu_torch.runtime import native_loader

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".gif")
# what the host batch decoder takes: a list of these alone goes to it
_NATIVE_EXTS = (".ppm", ".pgm", ".bmp")


def list_images(directory: str) -> List[str]:
    """Sorted image paths directly under `directory` and exactly one level of
    subdirectories below it; deeper nesting is ignored."""
    out = []
    try:
        entries = sorted(os.listdir(directory))
    except FileNotFoundError:
        return []
    for e in entries:
        p = os.path.join(directory, e)
        if os.path.isdir(p):
            for f in sorted(os.listdir(p)):
                if f.lower().endswith(_IMG_EXTS) and os.path.isfile(os.path.join(p, f)):
                    out.append(os.path.join(p, f))
        elif e.lower().endswith(_IMG_EXTS):
            out.append(p)
    return sorted(out)


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def to_unit(u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1], divided by 255 (not multiplied by its
    reciprocal), as `np.asarray(im, np.float32) / 255.0` computes it."""
    return np.asarray(u8, np.float32) / 255.0


def decode_resize(path: str, image_size: int) -> np.ndarray:
    """Decode to RGB, bilinear-resize to (image_size, image_size) as PIL
    does, scale to [0, 1]: (image_size, image_size, 3) float32."""
    rgb = _read(path)
    if rgb.shape[:2] != (image_size, image_size):
        rgb = resize_bilinear(rgb, (image_size, image_size))
    return to_unit(rgb)


def decode_original(path: str) -> np.ndarray:
    """Decode to RGB in [0, 1] at the file's own resolution: (H, W, 3)
    float32."""
    return to_unit(_read(path))


def _decode_batch(paths: List[str], image_size: int, num_workers: int,
                  allow_native: bool) -> Tuple[np.ndarray, bool]:
    """decode_resize_batch's array and whether the host batch decoder took it."""
    if allow_native and paths and all(p.lower().endswith(_NATIVE_EXTS) for p in paths):
        out, ok = native_loader.decode_batch(paths, image_size, num_threads=num_workers)
        for i in np.flatnonzero(ok == 0):  # refused: JAX's per-file path
            out[i] = decode_resize(paths[i], image_size)
        return out, True
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return np.stack(list(ex.map(lambda p: decode_resize(p, image_size), paths))), False


def decode_resize_batch(paths: List[str], image_size: int, num_workers: int = 4,
                        allow_native: bool = True) -> np.ndarray:
    """Decode and resize a list of files: (N, S, S, 3) float32 in [0, 1].
    Every file a PPM, PGM or BMP (and `allow_native`): the host batch decoder
    on `num_workers` C++ threads, each file it refuses through
    `decode_resize`; otherwise `decode_resize` on `num_workers` threads."""
    return _decode_batch(paths, image_size, num_workers, allow_native)[0]


def _with_ed(views: np.ndarray) -> np.ndarray:
    """(4 or 5, N, H, W, 3) -> 5 views, ED the channel-wise min of the four."""
    if views.shape[0] == 4:
        views = np.concatenate([views, views.min(axis=0, keepdims=True)], axis=0)
    return views


class PolarimetricDataset:
    """Aligned 5-view dataset yielding (V, B, H, W, 3) float32 batches in a
    deterministic order, shuffled per epoch when given a seed."""

    def __init__(self, cfg: DataConfig, image_size: int, batch_size: int,
                 num_workers: Optional[int] = None):
        self.cfg = cfg
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_workers = num_workers or cfg.num_workers
        self.used_native_decode = False

        names = cfg.psd_view_dirs if cfg.use_psd_naming else cfg.view_dirs
        self.view_names = list(names)
        paths = [os.path.join(cfg.data_dir, d) for d in self.view_names]

        self.has_ed_folder = os.path.isdir(paths[4])
        if not self.has_ed_folder and not cfg.est_diffuse:
            raise FileNotFoundError(f"ED folder {paths[4]} missing and est_diffuse=False")

        self.files: List[List[str]] = []
        for p in paths[:5 if self.has_ed_folder else 4]:
            fs = list_images(p)
            if not fs:
                raise FileNotFoundError(f"no images under {p}")
            self.files.append(fs)
        n = min(len(f) for f in self.files)
        self.files = [f[:n] for f in self.files]
        self.length = n

        self._cache: Optional[np.ndarray] = None
        if cfg.cache_in_memory:
            self._cache = self._decode(list(range(n)))

    def _decode(self, idx) -> np.ndarray:
        views = []
        for fs in self.files:
            arr, self.used_native_decode = _decode_batch(
                [fs[i] for i in idx], self.image_size, self.num_workers, True)
            views.append(arr)
        return _with_ed(np.stack(views))

    def _load_indices(self, idx: np.ndarray) -> np.ndarray:
        if self._cache is not None:
            return self._cache[:, idx]
        return self._decode(idx)

    def __len__(self) -> int:
        return self.length

    @property
    def batches_per_epoch(self) -> int:
        return self.length // self.batch_size

    def iter_epoch(self, shuffle_seed: Optional[int] = None, process_index: int = 0,
                   process_count: int = 1) -> Iterator[np.ndarray]:
        """(V, B_local, H, W, 3) batches. Every process walks the same global
        order (from `shuffle_seed`) and takes its contiguous block
        [p B/P, (p+1) B/P) of each global batch."""
        if self.batch_size % process_count != 0:
            raise ValueError(f"global batch {self.batch_size} not divisible by "
                             f"{process_count} processes")
        local = self.batch_size // process_count
        order = np.arange(self.length)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        for b in range(self.batches_per_epoch):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._load_indices(idx[process_index * local:(process_index + 1) * local])


class SingleFolderDataset:
    """A flat RGB folder for inference: (B, H, W, 3) batches in sorted file
    order, resized to image_size; image_size None keeps each file's own
    resolution, one file a batch."""

    def __init__(self, directory: str, image_size: Optional[int], batch_size: int = 1,
                 num_workers: int = 4, cache: bool = True):
        self.files = list_images(directory)
        if not self.files:
            raise FileNotFoundError(f"no images under {directory}")
        self.image_size = image_size
        self.batch_size = batch_size if image_size is not None else 1
        self.num_workers = num_workers
        self._cache: Optional[np.ndarray] = None
        self.used_native_decode = False
        if cache and image_size is not None:
            self._cache, self.used_native_decode = _decode_batch(self.files, image_size,
                                                                 num_workers, True)

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self.files)
        if self.image_size is None:
            for f in self.files:
                yield decode_original(f)[None]
            return
        for b in range(0, n, self.batch_size):
            idx = list(range(b, min(b + self.batch_size, n)))
            if self._cache is not None:
                yield self._cache[idx]
            else:
                yield np.stack([decode_resize(self.files[i], self.image_size) for i in idx])
