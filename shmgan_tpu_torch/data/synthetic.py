"""Synthetic polarimetric scenes: a numpy copy of shmgan_tpu/data/synthetic.py's
`synth_polar_scene`, `camera_image`, `synth_eval_set`, `synth_polar_batch`,
`write_fixture_tree` and `write_triplet_fixture_tree`. For the same seed the
arrays are bit for bit the JAX package's; the fixture trees' PNGs are
written through data/codecs.py instead of PIL and decode to the same pixels.

A scene is a textured random diffuse image plus view-dependent specular
highlights: the polarised specular part varies with the polariser angle as
Malus's cos^2 law, the diffuse part does not, so the four views share the
diffuse base and the channel-wise minimum across views approximates it.
Highlights are strong (past saturation), anisotropic and lightly tinted.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple, Union

import numpy as np

from shmgan_tpu_torch.data.codecs import encode_bmp, encode_png, encode_ppm

_VIEW_ANGLES_DEG = (0.0, 45.0, 90.0, 135.0)


def _smooth_noise(rng: np.random.Generator, h: int, w: int, c: int,
                  octaves: int = 4) -> np.ndarray:
    """Cheap multi-octave value noise in [0,1]."""
    out = np.zeros((h, w, c), np.float32)
    for o in range(octaves):
        step = max(1, min(h, w) >> (o + 1))
        gh, gw = max(2, h // step), max(2, w // step)
        coarse = rng.uniform(0, 1, (gh, gw, c)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        a = coarse[y0][:, x0]
        b = coarse[y0][:, x0 + 1]
        c_ = coarse[y0 + 1][:, x0]
        d = coarse[y0 + 1][:, x0 + 1]
        interp = a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx \
            + c_ * fy * (1 - fx) + d * fy * fx
        out += interp / (2 ** o)
    out /= sum(1.0 / 2 ** o for o in range(octaves))
    return out


def _specular_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Sum of anisotropic Gaussian highlight lobes, amplitude past saturation.

    Elongated lobes model reflections of extended/linear light sources; amplitudes
    in [0.7, 2.4] mean the bright cores clip to pure white in the rendered views
    (like real blown-out highlights), while the skirts stay in-range.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    spec = np.zeros((h, w), np.float32)
    n_highlights = int(rng.integers(2, 8))
    for _ in range(n_highlights):
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        sig_major = rng.uniform(0.025, 0.11) * min(h, w)
        aspect = rng.uniform(1.0, 4.0)
        sig_minor = max(sig_major / aspect, 0.6)
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v_ = -(xx - cx) * st + (yy - cy) * ct
        amp = rng.uniform(0.7, 2.4)
        spec += amp * np.exp(-(u ** 2 / (2 * sig_major ** 2)
                               + v_ ** 2 / (2 * sig_minor ** 2)))
    return spec


def synth_polar_scene(rng: np.random.Generator, h: int, w: int,
                      n_highlights: int | None = None):
    """One scene -> (views (4,H,W,3), diffuse (H,W,3), mask (H,W,1)).

    n_highlights is accepted for API compatibility; when None (default) the count
    is drawn per scene inside _specular_field.
    """
    diffuse = 0.12 + 0.76 * _smooth_noise(rng, h, w, 3)
    if n_highlights is None:
        spec = _specular_field(rng, h, w)
    else:
        # legacy explicit-count path (isotropic lobes), kept for targeted tests
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        spec = np.zeros((h, w), np.float32)
        for _ in range(n_highlights):
            cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
            sig = rng.uniform(0.03, 0.12) * min(h, w)
            amp = rng.uniform(0.7, 2.0)
            spec += amp * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                                   / (2 * sig ** 2)))
    # highlights carry the illuminant color: near-white with a light random tint
    tint = (1.0 - rng.uniform(0.0, 0.12, 3)).astype(np.float32)
    spec_rgb = spec[..., None] * tint
    # polarization phase of the specular component per scene
    phi = rng.uniform(0, np.pi)
    pol_frac = rng.uniform(0.6, 0.95)   # degree of polarization of the highlight
    views = []
    for ang in _VIEW_ANGLES_DEG:
        theta = np.deg2rad(ang)
        # Malus-law modulation of the polarized part; unpolarized part passes 1/2
        gain = (1 - pol_frac) * 0.5 + pol_frac * np.cos(theta - phi) ** 2
        v = np.clip(diffuse + spec_rgb * gain, 0, 1)
        views.append(v.astype(np.float32))
    mask = (spec > 0.25).astype(np.float32)[..., None]
    return np.stack(views), diffuse.astype(np.float32), mask


def camera_image(diffuse: np.ndarray, views: np.ndarray) -> np.ndarray:
    """What a normal (non-polarimetric) camera sees: diffuse + full-strength
    specular — reconstructed as diffuse + max over views of the per-view specular
    residue, i.e. the brightest polarized observation. This is the single-RGB
    inference input domain (test.py:21-39: trained model runs on one plain image).
    """
    residue = (views - diffuse[None]).max(axis=0)
    return np.clip(diffuse + residue, 0.0, 1.0).astype(np.float32)


def synth_eval_set(n: int, image_size: int, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Held-out eval pairs: (inputs (N,H,W,3) camera RGB with highlights,
    diffuse GT (N,H,W,3), masks (N,H,W,1)). The quality oracle is
    PSNR/SSIM(gen vs diffuse) > PSNR/SSIM(input vs diffuse) — the model must beat
    the identity baseline (reference oracle: test.py:332-366)."""
    rng = np.random.default_rng(seed)
    ins, gts, masks = [], [], []
    for _ in range(n):
        views, diffuse, mask = synth_polar_scene(rng, image_size, image_size)
        ins.append(camera_image(diffuse, views))
        gts.append(diffuse)
        masks.append(mask)
    return np.stack(ins), np.stack(gts), np.stack(masks)


def synth_polar_batch(batch: int, image_size: int, seed: int = 0,
                      include_ed: bool = True) -> np.ndarray:
    """(V, B, H, W, 3) float32 in [0, 1]: the four views of `batch` scenes,
    and with `include_ed` a fifth, their channel-wise minimum."""
    rng = np.random.default_rng(seed)
    v4 = np.stack([synth_polar_scene(rng, image_size, image_size)[0]
                   for _ in range(batch)], axis=1)
    if not include_ed:
        return v4
    return np.concatenate([v4, v4.min(axis=0, keepdims=True)], axis=0)


_ENCODERS = {"png": encode_png, "ppm": encode_ppm, "bmp": encode_bmp}


def _save_image(arr: np.ndarray, path: str, fmt: str = "png") -> None:
    """An image in [0, 1] as an 8-bit PNG (or PPM, BMP), truncated as
    `(np.clip(a, 0, 1) * 255).astype(np.uint8)` truncates."""
    with open(path, "wb") as f:
        f.write(_ENCODERS[fmt]((np.clip(arr, 0, 1) * 255).astype(np.uint8)))


def write_triplet_fixture_tree(root: str, n_images: int, image_size: int,
                               seed: int = 0, layout: str = "folder",
                               with_mask: bool = True) -> None:
    """An (image, diffuse[, mask/specular]) triplet tree for data/triplets.py:
    layout "folder": root/image/*.png, root/diffuse/*.png [, root/mask/*.png];
    layout "shiq": root/<stem>_A.png, <stem>_T.png [, <stem>_S.png]."""
    rng = np.random.default_rng(seed)
    if layout == "folder":
        for d in ["image", "diffuse"] + (["mask"] if with_mask else []):
            os.makedirs(os.path.join(root, d), exist_ok=True)
    else:
        os.makedirs(root, exist_ok=True)
    for i in range(n_images):
        views, diffuse, mask = synth_polar_scene(rng, image_size, image_size)
        img = camera_image(diffuse, views)
        if layout == "folder":
            _save_image(img, os.path.join(root, "image", f"img_{i:05d}.png"))
            _save_image(diffuse, os.path.join(root, "diffuse", f"img_{i:05d}.png"))
            if with_mask:
                _save_image(np.repeat(mask, 3, axis=-1),
                            os.path.join(root, "mask", f"img_{i:05d}.png"))
        else:
            _save_image(img, os.path.join(root, f"img{i:05d}_A.png"))
            _save_image(diffuse, os.path.join(root, f"img{i:05d}_T.png"))
            if with_mask:
                _save_image(np.clip(img - diffuse, 0, 1),
                            os.path.join(root, f"img{i:05d}_S.png"))


def write_fixture_tree(root: str, n_images: int, image_size: Union[int, Tuple[int, int]],
                       seed: int = 0,
                       view_dirs: Sequence[str] = ("I0", "I45", "I90", "I135", "ED"),
                       write_ed: bool = True, fmt: str = "png",
                       ed_mode: str = "min") -> None:
    """Write a polarimetric dataset tree the loader ingests:
    root/I0/img_00000.png ... root/ED/..., aligned by sorted file name.

    ed_mode: "min" writes ED as the channel-wise min of the 4 views (the
    reference's estimated diffuse); "diffuse" writes the scene's true diffuse
    image. `fmt` is "png", "ppm" or "bmp" (8-bit RGB, the bytes PIL writes).
    `image_size` is the side of a square, or (height, width).
    """
    if fmt not in _ENCODERS:
        raise ValueError(f"write_fixture_tree writes png, ppm or bmp, got fmt={fmt!r}")
    h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
    rng = np.random.default_rng(seed)
    dirs = list(view_dirs) if write_ed else list(view_dirs[:4])
    for d in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n_images):
        views, diffuse, _ = synth_polar_scene(rng, h, w)
        ed = diffuse if ed_mode == "diffuse" else views.min(axis=0)
        imgs = list(views) + ([ed] if write_ed else [])
        for d, img in zip(dirs, imgs):
            _save_image(img, os.path.join(root, d, f"img_{i:05d}.{fmt}"), fmt)
