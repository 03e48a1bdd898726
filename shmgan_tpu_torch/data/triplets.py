"""SHIQ-style (image, diffuse[, mask]) triplet datasets: the counterpart of
shmgan_tpu/data/triplets.py, reading through data/loader.py.

Two layouts on disk:

  folder:  root/image/*, root/diffuse/*, root/mask/* (mask/ optional; an
           empty one counts as missing), aligned by sorted file name;
  SHIQ:    one folder of <stem>_A (input), <stem>_T (specular-free) and
           optional <stem>_S (specular residue) files, grouped by stem.

Without a mask source the mask is the residue max(image - diffuse) over the
channels > 0.25, the synthetic curriculum's definition; a mask or specular
file is thresholded the same way on its channel maximum.

Consumers:
  specseg_pairs(batch, device)   (standardised Y, mask) tensors for SpecSeg
  triplet_to_views(batch)        the (5, B, H, W, 3) pseudo-view stack of the
                                 GAN step: the input in the four polariser
                                 slots, the diffuse ground truth as ED
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from shmgan_tpu_torch.data.loader import decode_resize_batch, list_images
from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.ops.standardize import per_image_standardization

_RESIDUE_THRESH = 0.25


def _group_by_suffix(files: List[str]) -> Tuple[List[str], List[str], List[Optional[str]]]:
    """SHIQ naming: <stem>_A (input), <stem>_T (diffuse), <stem>_S (specular);
    stems without both A and T are dropped."""
    by_stem: Dict[str, Dict[str, str]] = {}
    for f in files:
        base = os.path.splitext(os.path.basename(f))[0]
        if len(base) < 2 or base[-2] != "_":
            continue
        kind = base[-1].upper()
        if kind in ("A", "T", "S"):
            by_stem.setdefault(base[:-2], {})[kind] = f
    imgs, difs, specs = [], [], []
    for stem in sorted(by_stem):
        entry = by_stem[stem]
        if "A" in entry and "T" in entry:
            imgs.append(entry["A"])
            difs.append(entry["T"])
            specs.append(entry.get("S"))
    return imgs, difs, specs


def _residue_mask(image: np.ndarray, diffuse: np.ndarray) -> np.ndarray:
    residue = (image - diffuse).max(axis=-1, keepdims=True)
    return (residue > _RESIDUE_THRESH).astype(np.float32)


class TripletDataset:
    """Aligned triplets -> dicts {"image": (B, S, S, 3), "diffuse": (B, S, S,
    3), "mask": (B, S, S, 1)} of float32 in [0, 1]."""

    def __init__(self, root: str, image_size: int, batch_size: int = 8,
                 num_workers: int = 4, cache_in_memory: bool = True):
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        img_dir, dif_dir = os.path.join(root, "image"), os.path.join(root, "diffuse")
        if os.path.isdir(img_dir) and os.path.isdir(dif_dir):
            imgs, difs = list_images(img_dir), list_images(dif_dir)
            masks = list_images(os.path.join(root, "mask")) or None
            n = min(len(imgs), len(difs), len(masks) if masks else len(imgs))
            self._img_files, self._dif_files = imgs[:n], difs[:n]
            self._mask_files = masks[:n] if masks else None
        else:
            imgs, difs, specs = _group_by_suffix(list_images(root))
            self._img_files, self._dif_files = imgs, difs
            self._mask_files = specs if any(specs) else None
        if not self._img_files:
            raise FileNotFoundError(f"no triplets under {root}")
        self.length = len(self._img_files)
        self._cache: Optional[Dict[str, np.ndarray]] = None
        if cache_in_memory:
            self._cache = self._load(np.arange(self.length))

    def __len__(self) -> int:
        return self.length

    def _decode(self, files: List[str]) -> np.ndarray:
        return decode_resize_batch(files, self.image_size, self.num_workers)

    def _load(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            return {k: v[idx] for k, v in self._cache.items()}
        img = self._decode([self._img_files[i] for i in idx])
        dif = self._decode([self._dif_files[i] for i in idx])
        masks = []
        for j, i in enumerate(idx):
            f = self._mask_files[i] if self._mask_files is not None else None
            if f is None:
                masks.append(_residue_mask(img[j], dif[j]))
            else:
                raw = self._decode([f])[0]
                masks.append((raw.max(axis=-1, keepdims=True) > _RESIDUE_THRESH)
                             .astype(np.float32))
        return {"image": img, "diffuse": dif, "mask": np.stack(masks)}

    @property
    def batches_per_epoch(self) -> int:
        return self.length // self.batch_size

    def iter_epoch(self, shuffle_seed: Optional[int] = None, process_index: int = 0,
                   process_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Batches in the order of `shuffle_seed` (sorted when None); each
        process takes its contiguous block of every global batch."""
        if self.batch_size % process_count != 0:
            raise ValueError(f"global batch {self.batch_size} not divisible by "
                             f"{process_count} processes")
        local = self.batch_size // process_count
        order = np.arange(self.length)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        for b in range(self.batches_per_epoch):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._load(idx[process_index * local:(process_index + 1) * local])


def specseg_pairs(batch: Dict[str, np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triplet batch -> (standardised Y (B, S, S, 1), mask (B, S, S, 1)) on
    `device`, with the preprocessing every SpecSeg consumer applies."""
    y = rgb_to_yuv(torch.as_tensor(batch["image"], device=device))[..., 0:1]
    y_std, _ = per_image_standardization(y)
    return y_std, torch.as_tensor(batch["mask"], device=device)


def triplet_to_views(batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Triplet batch -> (5, B, S, S, 3): the input image in the four view
    slots, the diffuse ground truth as ED."""
    img = np.asarray(batch["image"])
    return np.stack([img, img, img, img, np.asarray(batch["diffuse"])])
