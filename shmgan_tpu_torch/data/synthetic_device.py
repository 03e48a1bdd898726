"""Synthetic polarimetric scenes made on the device: the counterpart of
shmgan_tpu/data/synthetic_jax.py (the base curriculum the GAN and SpecSeg
train on), so no training image crosses PCIe.

Value-noise diffuse textures (bilinear upsampling of uniform coarse grids,
octave weights 1/2^o) under up to MAX_LOBES anisotropic Gaussian specular
lobes, lightly tinted, whose polarised part follows Malus's law over the four
polariser angles; `camera` is the unpolarised observation (the diffuse base
plus the specular at its strongest view), the single-RGB inference input.

Every generator is split in two:
  `*_draws(gen, batch, h, w)`  every random draw of a batch, a NamedTuple of
                               tensors on the generator's device, each in the
                               range the JAX module draws it from;
  the render                   a deterministic function of those draws
                               (`smooth_noise`, `specular_field`,
                               `synth_scene`, `*_render`).
`synth_views_batch`, `synth_specseg_batch`, `synth_specseg_rgb_batch` and
`synth_eval_batch` chain the two. The CPU tests render the draws the JAX
module takes from its keys and hold the result against JAX's.

`jax.image.resize(..., "linear")` upsampling is `F.interpolate(...,
"bilinear", align_corners=False, antialias=False)`: half-pixel centres, the
edge clamped. `synth_specseg_batch` standardises the Y plane alone
(`per_image_standardization`), not the preprocess kernel's joint YUV
scaling, so it does not call that kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.ops.standardize import per_image_standardization

VIEW_ANGLES_RAD = (0.0, 0.7853981633974483, 1.5707963267948966, 2.356194490192345)
MAX_LOBES = 7      # lobes per scene: n in [2, 8)
OCTAVES = 4


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) float32 on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def randint(gen: torch.Generator, shape, lo: int, hi: int) -> torch.Tensor:
    """Integers in [lo, hi) on the generator's device."""
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) pixel coordinates, float32 (h, w)."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    return yy, xx


def map_draws(fn, draws):
    """fn applied to every tensor of a draws tree (NamedTuples, tuples,
    tensors; None stays None), e.g. to move draws to another device."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return fn(draws)
    items = [map_draws(fn, d) for d in draws]
    return type(draws)(*items) if hasattr(draws, "_fields") else tuple(items)


def take(draws, idx: torch.Tensor):
    """The draws of the scenes `idx`."""
    return map_draws(lambda t: t[idx], draws)


# -- multi-octave value noise ---------------------------------------------------

def octave_sizes(h: int, w: int, octaves: int = OCTAVES) -> Tuple[Tuple[int, int], ...]:
    sizes = []
    for o in range(octaves):
        step = max(1, min(h, w) >> (o + 1))
        sizes.append((max(2, h // step), max(2, w // step)))
    return tuple(sizes)


def noise_draws(gen: torch.Generator, batch: int, h: int, w: int, c: int,
                octaves: int = OCTAVES) -> Tuple[torch.Tensor, ...]:
    """The coarse grids of `smooth_noise`: U[0, 1) of (batch, gh, gw, c) each."""
    return tuple(uniform(gen, (batch, gh, gw, c)) for gh, gw in octave_sizes(h, w, octaves))


def smooth_noise(grids: Tuple[torch.Tensor, ...], h: int, w: int) -> torch.Tensor:
    """(B, h, w, c) value noise in [0, 1]: each grid upsampled bilinearly,
    weighted 1/2^o, normalised by the weights' sum."""
    out = None
    for o, coarse in enumerate(grids):
        interp = F.interpolate(coarse.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                               align_corners=False, antialias=False).permute(0, 2, 3, 1)
        term = interp / (2.0 ** o)
        out = term if out is None else out + term
    return out / sum(1.0 / 2 ** o for o in range(len(grids)))


# -- specular lobes ---------------------------------------------------------------

class LobeDraws(NamedTuple):
    n: torch.Tensor          # (B,) active lobes, in [2, MAX_LOBES + 1)
    cy: torch.Tensor         # (B, MAX_LOBES) in [0.1, 0.9), times h
    cx: torch.Tensor         # in [0.1, 0.9), times w
    sig_major: torch.Tensor  # in [0.025, 0.11), times min(h, w)
    aspect: torch.Tensor     # in [1, 4)
    theta: torch.Tensor      # in [0, pi)
    amp: torch.Tensor        # in [0.7, 2.4)


def lobe_draws(gen: torch.Generator, batch: int) -> LobeDraws:
    s = (batch, MAX_LOBES)
    return LobeDraws(n=randint(gen, (batch,), 2, MAX_LOBES + 1), cy=uniform(gen, s, 0.1, 0.9),
                     cx=uniform(gen, s, 0.1, 0.9), sig_major=uniform(gen, s, 0.025, 0.11),
                     aspect=uniform(gen, s, 1.0, 4.0), theta=uniform(gen, s, 0.0, math.pi),
                     amp=uniform(gen, s, 0.7, 2.4))


def specular_field(d: LobeDraws, h: int, w: int) -> torch.Tensor:
    """(B, h, w) sum of the anisotropic Gaussian lobes; lobes >= n have
    amplitude 0."""
    col = lambda t: t[:, :, None, None]  # noqa: E731  (B, L) -> (B, L, 1, 1)
    sig_major = d.sig_major * min(h, w)
    sig_minor = torch.clamp(sig_major / d.aspect, min=0.6)
    active = torch.arange(MAX_LOBES, device=d.n.device)[None, :] < d.n[:, None]
    amp = d.amp * active
    yy, xx = grid(h, w, d.cy.device)
    ct, st = col(torch.cos(d.theta)), col(torch.sin(d.theta))
    dy = yy - col(d.cy * h)
    dx = xx - col(d.cx * w)
    u = dx * ct + dy * st
    v = -dx * st + dy * ct
    lobes = col(amp) * torch.exp(-(u ** 2 / (2 * col(sig_major) ** 2)
                                   + v ** 2 / (2 * col(sig_minor) ** 2)))
    return lobes.sum(dim=1)


# -- scenes -----------------------------------------------------------------------

class SceneDraws(NamedTuple):
    noise: Tuple[torch.Tensor, ...]  # the diffuse texture's grids, c = 3
    lobes: LobeDraws
    tint: torch.Tensor               # (B, 3) in [0, 0.12): the tint is 1 - it
    phi: torch.Tensor                # (B,) polariser phase, in [0, pi)
    pol_frac: torch.Tensor           # (B,) in [0.6, 0.95)


def synth_scene_draws(gen: torch.Generator, batch: int, h: int, w: int) -> SceneDraws:
    return SceneDraws(noise=noise_draws(gen, batch, h, w, 3), lobes=lobe_draws(gen, batch),
                      tint=uniform(gen, (batch, 3), 0.0, 0.12),
                      phi=uniform(gen, (batch,), 0.0, math.pi),
                      pol_frac=uniform(gen, (batch,), 0.6, 0.95))


def synth_scene(d: SceneDraws, h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (views (B, 4, h, w, 3), diffuse (B, h, w, 3), mask (B, h, w, 1),
    camera (B, h, w, 3)): a shared diffuse base, the tinted specular field
    through each view's Malus gain; mask = field > 0.25."""
    diffuse = 0.12 + 0.76 * smooth_noise(d.noise, h, w)
    spec = specular_field(d.lobes, h, w)
    tint = 1.0 - d.tint
    spec_rgb = spec[..., None] * tint[:, None, None, :]
    angles = torch.tensor(VIEW_ANGLES_RAD, device=spec.device)
    pol = d.pol_frac[:, None]
    gains = (1 - pol) * 0.5 + pol * torch.cos(angles[None, :] - d.phi[:, None]) ** 2  # (B, 4)
    views = torch.clamp(diffuse[:, None] + spec_rgb[:, None] * gains[:, :, None, None, None],
                        0.0, 1.0)
    mask = (spec > 0.25).float()[..., None]
    max_gain = gains.amax(dim=1)
    camera = torch.clamp(diffuse + spec_rgb * max_gain[:, None, None, None], 0.0, 1.0)
    return views, diffuse, mask, camera


# -- batches ----------------------------------------------------------------------

class ViewsDraws(NamedTuple):
    scene: SceneDraws
    swap_u: torch.Tensor     # (B,) in [0, 1): swapped when < camera_swap_prob
    swap_slot: torch.Tensor  # (B,) the view replaced by the camera, in [0, 4)


def synth_views_batch_draws(gen: torch.Generator, batch: int, h: int, w: int) -> ViewsDraws:
    return ViewsDraws(scene=synth_scene_draws(gen, batch, h, w),
                      swap_u=uniform(gen, (batch,)), swap_slot=randint(gen, (batch,), 0, 4))


def swap_camera(views: torch.Tensor, camera: torch.Tensor, swap_u: torch.Tensor,
                swap_slot: torch.Tensor, camera_swap_prob: float) -> torch.Tensor:
    """views (4, B, h, w, 3) with view `slot` of each swapped scene replaced
    by its camera image."""
    if camera_swap_prob <= 0.0:
        return views
    do_swap = swap_u < camera_swap_prob
    slots = torch.arange(4, device=views.device)[:, None]
    sel = (slots == swap_slot[None, :]) & do_swap[None, :]
    return torch.where(sel[..., None, None, None], camera[None], views)


def synth_views_batch_render(d: ViewsDraws, h: int, w: int, ed_mode: str = "min",
                             camera_swap_prob: float = 0.0) -> torch.Tensor:
    """(5, B, h, w, 3): the 4 views (a camera image in place of one view
    with probability camera_swap_prob) and ED, the channel-wise min of the
    views (ed_mode "min") or the true diffuse layer ("diffuse")."""
    views, diffuse, _, camera = synth_scene(d.scene, h, w)
    views = swap_camera(views.movedim(1, 0), camera, d.swap_u, d.swap_slot, camera_swap_prob)
    ed = diffuse if ed_mode == "diffuse" else views.amin(dim=0)
    return torch.cat([views, ed[None]], dim=0)


def synth_views_batch(gen: torch.Generator, batch: int, h: int, w: int, ed_mode: str = "min",
                      camera_swap_prob: float = 0.0) -> torch.Tensor:
    return synth_views_batch_render(synth_views_batch_draws(gen, batch, h, w), h, w,
                                    ed_mode, camera_swap_prob)


class RGBDraws(NamedTuple):
    scene: SceneDraws
    pick: torch.Tensor  # (B,) which of the 4 views or the camera (4), in [0, 5)


def synth_specseg_rgb_batch_draws(gen: torch.Generator, batch: int, h: int, w: int) -> RGBDraws:
    return RGBDraws(scene=synth_scene_draws(gen, batch, h, w), pick=randint(gen, (batch,), 0, 5))


def synth_specseg_rgb_batch_render(d: RGBDraws, h: int, w: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RGB (B, h, w, 3) in [0, 1], mask (B, h, w, 1)): one of the five
    input domains (a polarised view or the camera) per scene."""
    views, _, mask, camera = synth_scene(d.scene, h, w)
    pool = torch.cat([views, camera[:, None]], dim=1)  # (B, 5, h, w, 3)
    rgb = pool[torch.arange(pool.shape[0], device=pool.device), d.pick]
    return rgb, mask


def synth_specseg_rgb_batch(gen: torch.Generator, batch: int, h: int, w: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return synth_specseg_rgb_batch_render(synth_specseg_rgb_batch_draws(gen, batch, h, w), h, w)


def standardized_luma(rgb: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 1): the Y plane divided by its own per-image scale."""
    return per_image_standardization(rgb_to_yuv(rgb)[..., 0:1])[0]


def synth_specseg_batch_render(d: RGBDraws, h: int, w: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(standardised Y (B, h, w, 1), mask (B, h, w, 1)): SpecSeg's training
    pairs from `synth_specseg_rgb_batch_render`."""
    rgb, mask = synth_specseg_rgb_batch_render(d, h, w)
    return standardized_luma(rgb), mask


def synth_specseg_batch(gen: torch.Generator, batch: int, h: int, w: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return synth_specseg_batch_render(synth_specseg_rgb_batch_draws(gen, batch, h, w), h, w)


def synth_eval_batch_render(d: SceneDraws, h: int, w: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(camera inputs (N, h, w, 3), diffuse truth (N, h, w, 3), masks
    (N, h, w, 1))."""
    _, diffuse, mask, camera = synth_scene(d, h, w)
    return camera, diffuse, mask


def synth_eval_batch(gen: torch.Generator, n: int, h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return synth_eval_batch_render(synth_scene_draws(gen, n, h, w), h, w)
