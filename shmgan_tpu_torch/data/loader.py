"""Image files in: the counterpart of shmgan_tpu/data/loader.py's
`list_images`, `decode_resize` and `decode_original`, decoding through
data/codecs.py instead of PIL, to the same float32 arrays."""

from __future__ import annotations

import os
from typing import List

import numpy as np

from shmgan_tpu_torch.data.codecs import decode, resize_bilinear

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".gif")


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
