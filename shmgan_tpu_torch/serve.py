"""Batch inference engine: the counterpart of shmgan_tpu/serve.py's
`BatchInferenceEngine`.

The engine runs at a fixed batch size with the weights resident on the
device, and pads a partial batch to that size, so every call the device sees
has one shape. Numpy in, numpy out: every output comes back as a float32
array. In bfloat16 compute `gen_y` is a bfloat16 tensor on the device and is
widened exactly to float32 on the host, where the JAX engine hands back an
`ml_dtypes.bfloat16` array (numpy has no bfloat16).

    gen, _, specseg = build_models(cfg, device="cuda", seed=0)
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=8)
    outputs = engine.process_images(rgb_batch)   # (N, H, W, 3) float32 in [0, 1]
    engine.process_folder(in_dir, out_dir)       # decode, infer, write PNGs
    engine.watch_folder(in_dir, out_dir)         # the same as a polling daemon

`native_resolution=True` serves each image at its own (h, w)
(`process_images_native`, infer.make_native_infer_fn); `outputs` restricts
the outputs computed and copied back (infer.make_infer_fn). Folder jobs
list the JAX package's extensions (data/loader.list_images) and decode
each file by its bytes (data/codecs.decode: PNG, JPEG, GIF, WebP, TIFF,
PNM, BMP), so a `.png`-named WebP is served as JAX serves it; a file that
does not decode (yet) is retried on the next poll.
`data_parallel=n` splits every device call of `batch_size` (the global
batch, which n must divide) into n shards over `devices` (default cuda:0..n-1,
or n copies of the CPU when `device` is the CPU), each with its replica of
the weights, as the JAX engine shards its batch over n devices.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.data.codecs import encode_png
from shmgan_tpu_torch.data.loader import decode_original, decode_resize, list_images
from shmgan_tpu_torch.infer import dp_devices, make_infer_fn, make_native_infer_fn


def _batch_axis(key: str) -> int:
    """cyc_rgb leads with c_dim; every other output with the batch."""
    return 1 if key == "cyc_rgb" else 0


def _take(v: np.ndarray, key: str, index) -> np.ndarray:
    return v[:, index] if key == "cyc_rgb" else v[index]


def _pad_batch(chunk: np.ndarray, batch_size: int) -> np.ndarray:
    if chunk.shape[0] == batch_size:
        return chunk
    pad = np.zeros((batch_size - chunk.shape[0],) + chunk.shape[1:], np.float32)
    return np.concatenate([chunk, pad])


def png_bytes(img01: np.ndarray) -> bytes:
    """An image in [0, 1] as an 8-bit PNG, truncated, not rounded, as the
    JAX package writes it: `(np.clip(x, 0, 1) * 255).astype(np.uint8)`."""
    return encode_png((np.clip(img01, 0, 1) * 255).astype(np.uint8))


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


class BatchInferenceEngine:
    def __init__(self, cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                 batch_size: int = 8, with_cyclic: bool = False, num_io_workers: int = 4,
                 native_resolution: bool = False, outputs=None, data_parallel: int = 1,
                 device: str = "cuda", devices: Optional[Sequence] = None):
        if data_parallel > 1 and batch_size % data_parallel:
            raise ValueError(f"batch_size {batch_size} must divide "
                             f"data_parallel {data_parallel}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.image_size = cfg.model.image_size
        self.native_resolution = native_resolution
        self.device = torch.device(device)
        self._dp = max(1, data_parallel)
        if self._dp > 1 and devices is None and self.device.type == "cpu":
            devices = [self.device] * self._dp
        dp = dict(data_parallel=self._dp, devices=devices)
        self._infer = make_infer_fn(cfg, with_cyclic=with_cyclic, outputs=outputs, **dp)
        self._native = (make_native_infer_fn(cfg, with_cyclic=with_cyclic, outputs=outputs,
                                             **dp)
                        if native_resolution else None)
        if self._dp > 1:
            # the weights live on the first device; the others hold replicas
            self.device = dp_devices(self._dp, devices)[0]
        self._gen = gen.to(self.device).eval()
        self._specseg = specseg.to(self.device).eval()
        self._io = ThreadPoolExecutor(max_workers=num_io_workers)

    def close(self) -> None:
        """Stop the decode threads."""
        self._io.shutdown(wait=True)

    def warmup(self) -> None:
        """One call on a zero batch at the engine's shape (the square
        image_size bucket on the native path), so that the first request
        does not pay cuDNN's algorithm choice and the allocator's growth."""
        dummy = np.zeros((self.batch_size, self.image_size, self.image_size, 3), np.float32)
        if self.native_resolution:
            self.process_images_native(list(dummy))
        else:
            self.process_images(dummy)

    # -- core -----------------------------------------------------------------

    def process_images(self, rgb: np.ndarray) -> Dict[str, np.ndarray]:
        """(N, H, W, 3) float32 in [0, 1] -> dict of numpy outputs with N
        leading (cyc_rgb: (c_dim, N, H, W, 3))."""
        rgb = np.asarray(rgb, np.float32)
        if rgb.ndim != 4 or rgb.shape[-1] != 3 or rgb.shape[0] == 0:
            raise ValueError(f"process_images: expected (N, H, W, 3), got {rgb.shape}")
        outs = []
        for i in range(0, rgb.shape[0], self.batch_size):
            chunk = rgb[i:i + self.batch_size]
            real = chunk.shape[0]
            x = torch.from_numpy(np.ascontiguousarray(_pad_batch(chunk, self.batch_size)))
            # data parallel: the shards go from the host to their devices
            out = self._infer(self._gen, self._specseg,
                              x if self._dp > 1 else x.to(self.device))
            outs.append({k: _take(v, k, slice(0, real)).cpu().float().numpy()
                         for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=_batch_axis(k)) for k in outs[0]}

    def process_images_native(self, images) -> List[Dict[str, np.ndarray]]:
        """A list of (h, w, 3) float32 images in [0, 1], of any sizes -> a
        list of per-image output dicts, in order. Images of one (h, w) run
        together, in chunks of the batch size padded with zeros."""
        if self._native is None:
            raise RuntimeError("engine was built with native_resolution=False")
        groups: Dict[tuple, list] = {}
        for idx, img in enumerate(images):
            groups.setdefault(np.shape(img)[:2], []).append(idx)
        results: list = [None] * len(images)
        for idxs in groups.values():
            stack = np.stack([np.asarray(images[i], np.float32) for i in idxs])
            for c0 in range(0, len(idxs), self.batch_size):
                chunk = stack[c0:c0 + self.batch_size]
                out = self._native(self._gen, self._specseg,
                                   _pad_batch(chunk, self.batch_size))
                for j in range(chunk.shape[0]):
                    results[idxs[c0 + j]] = {k: _take(v, k, j) for k, v in out.items()}
        return results

    # -- folder jobs ----------------------------------------------------------

    def _save_outputs(self, out: Dict[str, np.ndarray], names, out_dir: str,
                      save_mask: bool, debug_stretch: bool = False) -> None:
        """Write `<name>_specfree.png` (the calibrated output), with save_mask
        `<name>_mask.png`, and with debug_stretch `<name>_stretch.png` (gen_rgb
        stretched to its own min and max)."""
        os.makedirs(out_dir, exist_ok=True)
        gen = out["gen_rgb_calibrated"]
        for j, name in enumerate(names):
            base = os.path.join(out_dir, os.path.splitext(os.path.basename(name))[0])
            _write(f"{base}_specfree.png", png_bytes(gen[j]))
            if save_mask:
                _write(f"{base}_mask.png", png_bytes(out["mask"][j, ..., 0]))
            if debug_stretch:
                img = out["gen_rgb"][j]
                lo, hi = img.min(), img.max()
                _write(f"{base}_stretch.png",
                       png_bytes((img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)))

    def process_folder(self, in_dir: str, out_dir: str, save_mask: bool = True) -> int:
        """Decode, infer and save every image of `in_dir`; returns how many."""
        return len(self._process_files(list_images(in_dir), out_dir, save_mask))

    def _try_decode(self, path: str) -> Optional[np.ndarray]:
        """The decoded image, or None for a file that cannot be read or
        decoded yet (mid-write, truncated or corrupt, or too large for the
        host's memory now), which a later poll retries."""
        try:
            if self.native_resolution:
                return decode_original(path)
            return decode_resize(path, self.image_size)
        except (OSError, ValueError, MemoryError):
            return None

    def _process_files(self, files, out_dir: str, save_mask: bool) -> list:
        """Decode, infer and save; returns the files that decoded."""
        if not files:
            return []
        decoded = list(self._io.map(self._try_decode, files))
        ok = [(f, d) for f, d in zip(files, decoded) if d is not None]
        if not ok:
            return []
        ok_files = [f for f, _ in ok]
        if self.native_resolution:
            outs = self.process_images_native([d for _, d in ok])
            for f, out in zip(ok_files, outs):
                self._save_outputs({k: _take(v, k, None) for k, v in out.items()},
                                   [f], out_dir, save_mask)
        else:
            out = self.process_images(np.stack([d for _, d in ok]))
            self._save_outputs(out, ok_files, out_dir, save_mask)
        return ok_files

    def watch_folder(self, in_dir: str, out_dir: str, poll_s: float = 1.0,
                     save_mask: bool = True, max_iterations: Optional[int] = None) -> None:
        """Poll `in_dir` and process images as they arrive. A file is taken
        once its (size, mtime) is the same on two polls in a row; a file that
        does not decode is tried again on later polls; files that disappear
        are forgotten. A poll that processes nothing sleeps `poll_s`.
        max_iterations bounds the loop; None runs forever."""
        seen: Set[str] = set()
        pending: Dict[str, tuple] = {}
        it = 0
        while max_iterations is None or it < max_iterations:
            stable = []
            current = set(list_images(in_dir))
            for gone in [f for f in pending if f not in current]:
                pending.pop(gone, None)
            seen &= current
            for f in sorted(current):
                if f in seen:
                    continue
                try:
                    st = os.stat(f)
                except OSError:
                    continue
                sig = (st.st_size, st.st_mtime_ns)
                if pending.get(f) == sig:
                    stable.append(f)
                pending[f] = sig
            done = self._process_files(stable, out_dir, save_mask) if stable else []
            seen.update(done)
            for f in done:
                pending.pop(f, None)
            if done:
                print(f"[serve] processed {len(done)} image(s)")
            else:
                time.sleep(poll_s)
            it += 1
