"""Model summaries, image plots and the hdf5 dump: the counterpart of
shmgan_tpu/utils/viz.py. The summaries read flax-layout trees (nested dicts
of arrays, as `convert.flax_tree` lays a module out), so the text is the JAX
package's, line for line, for the same configuration.

`image_grid`, `debug_plot` and `plot_single_image` write their panels as an
8-bit PNG through data/codecs.encode_png, without matplotlib: each panel
rescaled for display (debug_plot's label planes clipped to [0, 1], as JAX
draws them with vmin 0 and vmax 1), a one-channel panel as grey, GRID_GAP
white pixels between panels, no title text drawn (a deliberate difference
from the JAX package's figures). Each returns the uint8 image it wrote.
`save_dataset_hdf5` writes through runtime/hdf5.py.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import encode_png
from shmgan_tpu_torch.runtime import hdf5

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


def _panel(img: Any, rescale: bool = True) -> np.ndarray:
    """(H, W), (H, W, 1) or (H, W, 3) as (H, W, 3) uint8: rescaled for
    display, or else clipped to [0, 1]."""
    arr = np.squeeze(np.asarray(img, dtype=np.float32))
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an image (H, W[, 1|3]), got {np.shape(img)}")
    arr = rescale_for_display(arr) if rescale else np.clip(arr, 0.0, 1.0)
    return np.round(arr * 255.0).astype(np.uint8)


def _tile(rows: Sequence[Sequence[np.ndarray]], path: Optional[str]) -> np.ndarray:
    """Rows of uint8 panels, GRID_GAP white pixels apart (the shorter or
    narrower ones padded white), written to `path` as a PNG when given."""
    h = max(p.shape[0] for row in rows for p in row)
    lines = []
    for row in rows:
        gap = np.full((h, GRID_GAP, 3), 255, np.uint8)
        line = []
        for i, p in enumerate(row):
            if i:
                line.append(gap)
            line.append(np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)), constant_values=255))
        lines.append(np.concatenate(line, axis=1))
    w = max(line.shape[1] for line in lines)
    stack = []
    for i, line in enumerate(lines):
        if i:
            stack.append(np.full((GRID_GAP, w, 3), 255, np.uint8))
        stack.append(np.pad(line, ((0, 0), (0, w - line.shape[1]), (0, 0)), constant_values=255))
    out = np.concatenate(stack, axis=0)
    if path:
        with open(path, "wb") as f:
            f.write(encode_png(out))
    return out


def image_grid(images: Sequence[Any], titles: Optional[Sequence[str]] = None,
               path: Optional[str] = None) -> np.ndarray:
    """A row of images, each (H, W), (H, W, 1) or (H, W, 3), rescaled for
    display (a one-channel image as grey), GRID_GAP white pixels apart:
    the (H, W_total, 3) uint8 row, written to `path` as a PNG when given.
    `titles` is the JAX signature's; no text is drawn."""
    del titles
    return _tile([[_panel(img) for img in images]], path)


def debug_plot(gen_input: Any, path: Optional[str] = None) -> np.ndarray:
    """A packed generator input (1, H, W, 2C): its C image channels in one
    row (each rescaled for display), its C label planes in the row below
    (clipped to [0, 1]); the uint8 image, written to `path` when given."""
    t = np.squeeze(np.asarray(gen_input, dtype=np.float32))
    if t.ndim != 3 or t.shape[-1] % 2:
        raise ValueError(f"debug_plot: expected (1, H, W, 2C), got {np.shape(gen_input)}")
    c = t.shape[-1] // 2
    return _tile([[_panel(t[..., i]) for i in range(c)],
                  [_panel(t[..., c + i], rescale=False) for i in range(c)]], path)


def plot_single_image(img: Any, title: str = "", path: Optional[str] = None) -> np.ndarray:
    """One grey panel for an (H, W) or (H, W, 1) image; for an (H, W, 3) one
    the original over its three channels, a column of four panels, each
    rescaled for display. `title` is the JAX signature's; no text is
    drawn."""
    del title
    arr = np.squeeze(np.asarray(img, dtype=np.float32))
    if arr.ndim == 2:
        return _tile([[_panel(arr)]], path)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"plot_single_image: expected (H, W[, 1|3]), got {np.shape(img)}")
    return _tile([[_panel(arr)]] + [[_panel(arr[..., i])] for i in range(3)], path)


def save_dataset_hdf5(image_stack: Any, path: str = "./estimated_diffuse_images.hdf5",
                      dataset_name: str = "default") -> int:
    """Add `image_stack` to the hdf5 file at `path` (made if absent) as the
    dataset `dataset_name`, chunked and deflated at level 9, its dtype
    kept; returns the file's size in bytes. A name already in the file, or
    a file holding anything but datasets (runtime/hdf5.append_dataset),
    raises."""
    return hdf5.append_dataset(path, dataset_name, np.asarray(image_stack))
