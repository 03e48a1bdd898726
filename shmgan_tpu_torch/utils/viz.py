"""Model summaries and image grids: the counterpart of shmgan_tpu/utils/viz.py's
`model_summary`, `write_model_summaries`, `rescale_for_display` and
`image_grid`. The summaries read flax-layout trees (nested dicts of arrays,
as `convert.flax_tree` lays a module out), so the text is the JAX package's,
line for line, for the same configuration.

`image_grid` writes its row of panels as an 8-bit PNG through
data/codecs.encode_png, without matplotlib: each panel rescaled for display,
a one-channel panel as grey, no title text drawn (a deliberate difference
from the JAX package's figure). viz.py's `debug_plot`, `plot_single_image`
and its hdf5 dump are not ported.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import encode_png

GRID_GAP = 4   # pixels of white between two panels


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in sorted key order at every level, as a JAX tree
    flatten walks a dict."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def model_summary(params: Mapping, name: str = "model") -> str:
    """A keras-summary-style table of a parameter tree: one row per leaf
    (path, shape, count) and the total."""
    lines = [f'Model: "{name}"', "=" * 64,
             f"{'Path':<44}{'Shape':<14}Params", "-" * 64]
    total = 0
    for key, leaf in _leaves(params):
        shape = tuple(int(d) for d in np.shape(leaf))
        n = int(np.prod(shape)) if shape else 1
        total += n
        lines.append(f"{key:<44}{str(shape):<14}{n:,}")
    lines += ["=" * 64, f"Total params: {total:,}"]
    return "\n".join(lines)


def write_model_summaries(g_params: Mapping, d_params: Mapping, specseg_vars: Mapping,
                          out_dir: str = ".") -> None:
    """Generator_summary.txt, Discriminator_summary.txt and SpecSeg_summary.txt
    under `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    for fname, tree, name in (
            ("Generator_summary.txt", g_params, "SHM_Generator"),
            ("Discriminator_summary.txt", d_params, "SHM_Discriminator"),
            ("SpecSeg_summary.txt", specseg_vars, "SpecSeg")):
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(model_summary(tree, name) + "\n")


def rescale_for_display(img: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1]; a constant image becomes zeros."""
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def image_grid(images: Sequence[Any], titles: Optional[Sequence[str]] = None,
               path: Optional[str] = None) -> np.ndarray:
    """A row of images, each (H, W), (H, W, 1) or (H, W, 3), rescaled for
    display (a one-channel image as grey), GRID_GAP white pixels apart:
    the (H, W_total, 3) uint8 row, written to `path` as a PNG when given.
    `titles` is the JAX signature's; no text is drawn."""
    del titles
    panels = []
    for img in images:
        arr = np.squeeze(np.asarray(img, dtype=np.float32))
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"image_grid: expected (H, W[, 1|3]), got {np.shape(img)}")
        panels.append(np.round(rescale_for_display(arr) * 255.0).astype(np.uint8))
    h = max(p.shape[0] for p in panels)
    gap = np.full((h, GRID_GAP, 3), 255, np.uint8)
    row = []
    for i, p in enumerate(panels):
        if i:
            row.append(gap)
        row.append(np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)), constant_values=255))
    grid = np.concatenate(row, axis=1)
    if path:
        with open(path, "wb") as f:
            f.write(encode_png(grid))
    return grid
