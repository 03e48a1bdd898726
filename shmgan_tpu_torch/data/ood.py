"""The out-of-distribution synthetic scene family: the port's own numpy copy
of shmgan_tpu/data/ood.py's `synth_ood_set` and its helpers, bit for bit
from the same `np.random.default_rng(seed)`. `--specseg_probe ood` scores
SpecSeg on it.

Its statistics are unlike the training curricula's on purpose:
piecewise-flat backgrounds (Voronoi cells or stripes), hard-edged
super-Gaussian plateaus and thin curved glints, untinted highlights,
vignetting and a per-image gamma. Ground truth (diffuse and mask) exists.

`reference_photo_crops` cuts the reference's results figure (a 3 x 10 grid
of input photographs, the reference SpecSeg's masks and the reference
SHMGAN's outputs, with white gutters) into arrays, as the JAX function
does: the file is read through data/codecs.py (PIL's `convert("RGB")`
pixels) and each cell resized by `codecs.resize_bilinear` (Pillow's
BILINEAR, exactly). The figure is not in the repository; where it is absent
the function returns None, and the evaluators then skip their real-photo
part.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from shmgan_tpu_torch.data.codecs import decode, resize_bilinear

# the JAX package's default: the reference repository checked out in the
# home directory, its assets/results.png
REFERENCE_RESULTS_PNG = os.path.join(os.path.expanduser("~"), "reference", "assets",
                                     "results.png")


def _voronoi_cells(rng: np.random.Generator, h: int, w: int,
                   n_cells: int) -> np.ndarray:
    """Piecewise-flat colored cells — nothing like value-noise textures."""
    cy = rng.uniform(0, h, n_cells)
    cx = rng.uniform(0, w, n_cells)
    colors = rng.uniform(0.05, 0.95, (n_cells, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2
    return colors[np.argmin(d2, axis=-1)]


def _stripes(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    theta = rng.uniform(0, np.pi)
    period = rng.uniform(0.08, 0.3) * min(h, w)
    phase = (xx * np.cos(theta) + yy * np.sin(theta)) / period
    c0 = rng.uniform(0.05, 0.9, 3).astype(np.float32)
    c1 = rng.uniform(0.05, 0.9, 3).astype(np.float32)
    t = ((np.sin(2 * np.pi * phase) > 0)).astype(np.float32)[..., None]
    return c0 * t + c1 * (1 - t)


def _ood_specular(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Hard-edged plateaus (super-Gaussian, exponent 3-6) + thin arc glints.

    The curriculum's lobes are exponent-1 Gaussians; these have near-binary
    cores with steep skirts, so both the mask net and the generator see edge
    profiles they never trained on.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    spec = np.zeros((h, w), np.float32)
    for _ in range(int(rng.integers(1, 7))):
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        sig_a = rng.uniform(0.02, 0.09) * min(h, w)
        sig_b = sig_a / rng.uniform(1.0, 3.0)
        th = rng.uniform(0, np.pi)
        ct, st = np.cos(th), np.sin(th)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        p = rng.uniform(3.0, 6.0)  # super-Gaussian exponent: plateau + cliff
        r = (u / sig_a) ** 2 + (v / sig_b) ** 2
        spec += rng.uniform(0.9, 2.2) * np.exp(-0.5 * r ** (p / 2.0))
    for _ in range(int(rng.integers(0, 4))):  # thin curved glints
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        rad = rng.uniform(0.08, 0.3) * min(h, w)
        width = rng.uniform(0.6, 2.0)
        a0 = rng.uniform(0, 2 * np.pi)
        arc = rng.uniform(0.4, 1.6)
        ang = np.arctan2(yy - cy, xx - cx)
        dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        dang = np.angle(np.exp(1j * (ang - a0)))
        on_arc = (np.abs(dang) < arc / 2).astype(np.float32)
        spec += rng.uniform(0.8, 1.8) * on_arc * np.exp(
            -0.5 * ((dist - rad) / width) ** 2)
    return spec


def synth_ood_scene(rng: np.random.Generator, h: int, w: int):
    """-> (camera_rgb (H,W,3), diffuse (H,W,3), mask (H,W,1)), all float32."""
    if rng.uniform() < 0.5:
        base = _voronoi_cells(rng, h, w, int(rng.integers(4, 14)))
    else:
        base = _stripes(rng, h, w)
    # vignette + per-image gamma: photometric stats unlike the curriculum
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((yy / h - 0.5) ** 2 + (xx / w - 0.5) ** 2) / 0.5
    vign = 1.0 - rng.uniform(0.0, 0.35) * r2
    gamma = rng.uniform(0.8, 1.4)
    diffuse = np.clip(base * vign[..., None], 0, 1) ** gamma
    diffuse = (0.06 + 0.88 * diffuse).astype(np.float32)

    spec = _ood_specular(rng, h, w)
    camera = np.clip(diffuse + spec[..., None], 0, 1).astype(np.float32)
    mask = (spec > 0.25).astype(np.float32)[..., None]
    return camera, diffuse.astype(np.float32), mask


def synth_ood_set(n: int, image_size: int, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inputs (N,H,W,3), diffuse GT (N,H,W,3), masks (N,H,W,1)) — the same
    contract as data/synthetic.py::synth_eval_set, from the OOD family."""
    rng = np.random.default_rng(seed)
    ins, gts, masks = [], [], []
    for _ in range(n):
        cam, diff, mask = synth_ood_scene(rng, image_size, image_size)
        ins.append(cam)
        gts.append(diff)
        masks.append(mask)
    return np.stack(ins), np.stack(gts), np.stack(masks)


# -- real photographs from the reference's results figure ------------------------------

def _content_runs(mean_profile: np.ndarray, thresh: float = 250.0) -> List[Tuple[int, int]]:
    """Split a 1-D brightness profile into content spans (start, stop)
    separated by near-white gutters (above `thresh`); spans of 16 pixels or
    fewer are dropped."""
    white = mean_profile > thresh
    spans, start = [], None
    for i, w in enumerate(white):
        if not w and start is None:
            start = i
        if w and start is not None:
            spans.append((start, i))
            start = None
    if start is not None:
        spans.append((start, len(white)))
    return [s for s in spans if s[1] - s[0] > 16]


def reference_photo_crops(image_size: int, path: str = REFERENCE_RESULTS_PNG
                          ) -> Optional[dict]:
    """The reference results grid cut into cells, each resized to
    image_size: {"inputs": (N, S, S, 3), "ref_masks": (N, S, S, 1),
    "ref_outputs": (N, S, S, 3)}, float32 in [0, 1]; None when the file is
    absent or holds fewer than 3 row spans or 2 column spans. Rows: the input
    photos, the reference SpecSeg's masks (the cell's channel mean), the
    reference SHMGAN's outputs. A column span at or under 0.6 of the median
    width (the rotated row labels) is dropped."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        im = decode(f.read())
    col_spans = _content_runs(im.mean(axis=(0, 2)))
    row_spans = _content_runs(im.mean(axis=(1, 2)))
    if len(row_spans) < 3 or len(col_spans) < 2:
        return None
    med = float(np.median([c1 - c0 for c0, c1 in col_spans]))
    col_spans = [s for s in col_spans if (s[1] - s[0]) > 0.6 * med]

    def cells(row: int) -> np.ndarray:
        r0, r1 = row_spans[row]
        return np.stack([resize_bilinear(im[r0:r1, c0:c1], (image_size, image_size))
                         .astype(np.float32) / 255.0 for c0, c1 in col_spans])

    return {"inputs": cells(0), "ref_masks": cells(1).mean(axis=-1, keepdims=True),
            "ref_outputs": cells(2)}
