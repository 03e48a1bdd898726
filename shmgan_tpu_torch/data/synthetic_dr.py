"""The domain-randomised SpecSeg curriculum, made on the device: the
counterpart of the SpecSeg half of shmgan_tpu/data/synthetic_dr.py
(`--specseg_curriculum dr|dr2|dr3`).

A DR scene keeps the base curriculum's physics (data/synthetic_device.py)
and randomises what a mask net could otherwise learn as a shortcut:
  - texture: value noise, Voronoi cells, stripes or a gradient (one family a
    scene), and with `photo` (dr3) half the scenes take a composite of a
    1/f^alpha spectrum background and a second family behind a soft
    object-like boundary;
  - up to MAX_DISTRACTORS bright but diffuse regions (label 0), screen-blended
    toward white so the texture survives inside them;
  - exposure, gamma, vignette, and additive sensor noise on the camera image;
  - speculars with super-Gaussian edge profiles, aspect up to 6, a bloom
    skirt and amplitudes that clip, and with `glints` (dr2, dr3) up to
    MAX_GLINTS tiny spots clustered about N_GLINT_CLUSTERS centres.
The label stays the specular field > 0.25.

As in data/synthetic_device.py every generator is a `*_draws` function (the
random draws, on the generator's device) and a deterministic render. A batch
renders each texture family only for the scenes that drew it.

`_tex_spectrum` shapes white noise with `torch.fft.rfft2` / `irfft2`, which
round otherwise than XLA's FFT; the min-max normalisation that follows keeps
the texture within 1e-5 of JAX's (tests/test_torch_synthetic_device.py).

The GAN phase's DR curriculum (`--gan_curriculum dr`): `synth_scene_views_dr`
lays a DR scene out as a polarimetric stack (Malus's gains over the four
polariser angles, sensor noise drawn for each view and for the camera), and
`synth_views_batch_dr` mixes floor(batch * base_mix) base-curriculum stacks
(data/synthetic_device.synth_views_batch) with DR ones, the base stacks first
along the batch axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from shmgan_tpu_torch.data.synthetic_device import (
    MAX_LOBES, VIEW_ANGLES_RAD, RGBDraws, ViewsDraws, grid, noise_draws, randint, smooth_noise,
    standardized_luma, swap_camera, synth_specseg_rgb_batch_draws,
    synth_specseg_rgb_batch_render, synth_views_batch_draws, synth_views_batch_render, take,
    uniform)
from shmgan_tpu_torch.ops.specprior import specseg_net_input

MAX_DISTRACTORS = 3   # bright diffuse regions a scene, 0..3 active
N_VORONOI = 16        # Voronoi seeds a scene
MAX_GLINTS = 56       # dr2: micro-glints a scene, 0..56 active
N_GLINT_CLUSTERS = 4
_FLT_MIN = torch.finfo(torch.float32).tiny  # the smallest normal float32

def _col(t: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, K) -> broadcastable against (B, [K,] h, w)."""
    return t[..., None, None]


# -- texture families, (B, h, w, 3) in [0, 1] ---------------------------------------

class ValueNoiseDraws(NamedTuple):
    noise: Tuple[torch.Tensor, ...]  # grids, c = 3
    lo: torch.Tensor                 # (B,) in [0.02, 0.25)
    hi: torch.Tensor                 # (B,) in [0.6, 0.97)


class VoronoiDraws(NamedTuple):
    cy: torch.Tensor      # (B, N_VORONOI) in [0, 1), times h
    cx: torch.Tensor      # times w
    colors: torch.Tensor  # (B, N_VORONOI, 3) in [0.05, 0.95)


class StripesDraws(NamedTuple):
    theta: torch.Tensor   # (B,) in [0, pi)
    period: torch.Tensor  # (B,) in [0.08, 0.35), times min(h, w)
    c0: torch.Tensor      # (B, 3) in [0.05, 0.92)
    c1: torch.Tensor


class GradientDraws(NamedTuple):
    theta: torch.Tensor   # (B,) in [0, 2 pi)
    c0: torch.Tensor      # (B, 3) in [0.03, 0.95)
    c1: torch.Tensor


class SpectrumDraws(NamedTuple):
    alpha: torch.Tensor   # (B,) in [0.8, 1.8)
    white: torch.Tensor   # (B, h, w) standard normal
    c0: torch.Tensor      # (B, 3) in [0.02, 0.55)
    c1: torch.Tensor      # (B, 3) in [0.4, 0.97)


class PhotoDraws(NamedTuple):
    bg: SpectrumDraws
    pick: torch.Tensor    # (B,) the foreground family, in [0, 4)
    value_noise: ValueNoiseDraws
    voronoi: VoronoiDraws
    stripes: StripesDraws
    spectrum: SpectrumDraws
    level: torch.Tensor   # (B,) in [0.35, 0.65)
    boundary: Tuple[torch.Tensor, ...]  # the boundary's noise grids, c = 1


class TextureDraws(NamedTuple):
    pick: torch.Tensor    # (B,) family, in [0, 4); with photo in [0, 8), 4.. the photo
    value_noise: ValueNoiseDraws
    voronoi: VoronoiDraws
    stripes: StripesDraws
    gradient: GradientDraws
    photo: Optional[PhotoDraws]


def _value_noise_draws(gen, b, h, w) -> ValueNoiseDraws:
    return ValueNoiseDraws(noise=noise_draws(gen, b, h, w, 3), lo=uniform(gen, (b,), 0.02, 0.25),
                           hi=uniform(gen, (b,), 0.6, 0.97))


def _voronoi_draws(gen, b) -> VoronoiDraws:
    return VoronoiDraws(cy=uniform(gen, (b, N_VORONOI)), cx=uniform(gen, (b, N_VORONOI)),
                        colors=uniform(gen, (b, N_VORONOI, 3), 0.05, 0.95))


def _stripes_draws(gen, b) -> StripesDraws:
    return StripesDraws(theta=uniform(gen, (b,), 0.0, math.pi),
                        period=uniform(gen, (b,), 0.08, 0.35),
                        c0=uniform(gen, (b, 3), 0.05, 0.92), c1=uniform(gen, (b, 3), 0.05, 0.92))


def _gradient_draws(gen, b) -> GradientDraws:
    return GradientDraws(theta=uniform(gen, (b,), 0.0, 2 * math.pi),
                         c0=uniform(gen, (b, 3), 0.03, 0.95), c1=uniform(gen, (b, 3), 0.03, 0.95))


def _spectrum_draws(gen, b, h, w) -> SpectrumDraws:
    return SpectrumDraws(alpha=uniform(gen, (b,), 0.8, 1.8),
                         white=torch.randn((b, h, w), generator=gen, device=gen.device),
                         c0=uniform(gen, (b, 3), 0.02, 0.55), c1=uniform(gen, (b, 3), 0.4, 0.97))


def _photo_draws(gen, b, h, w) -> PhotoDraws:
    return PhotoDraws(bg=_spectrum_draws(gen, b, h, w), pick=randint(gen, (b,), 0, 4),
                      value_noise=_value_noise_draws(gen, b, h, w),
                      voronoi=_voronoi_draws(gen, b), stripes=_stripes_draws(gen, b),
                      spectrum=_spectrum_draws(gen, b, h, w),
                      level=uniform(gen, (b,), 0.35, 0.65),
                      boundary=noise_draws(gen, b, h, w, 1))


def texture_draws(gen: torch.Generator, batch: int, h: int, w: int,
                  photo: bool = False) -> TextureDraws:
    """Every family's draws for every scene; the render reads the family
    each scene picked."""
    return TextureDraws(pick=randint(gen, (batch,), 0, 8 if photo else 4),
                        value_noise=_value_noise_draws(gen, batch, h, w),
                        voronoi=_voronoi_draws(gen, batch), stripes=_stripes_draws(gen, batch),
                        gradient=_gradient_draws(gen, batch),
                        photo=_photo_draws(gen, batch, h, w) if photo else None)


def _tex_value_noise(d: ValueNoiseDraws, h: int, w: int) -> torch.Tensor:
    lo, hi = d.lo[:, None, None, None], d.hi[:, None, None, None]
    return lo + (hi - lo) * smooth_noise(d.noise, h, w)


def _tex_voronoi(d: VoronoiDraws, h: int, w: int) -> torch.Tensor:
    yy, xx = grid(h, w, d.cy.device)
    cy = (d.cy * h)[:, None, None, :]
    cx = (d.cx * w)[:, None, None, :]
    d2 = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2     # (B, h, w, N)
    idx = torch.argmin(d2, dim=-1)
    return torch.gather(d.colors, 1, idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, 3)
                        ).view(idx.shape[0], h, w, 3)


def _tex_stripes(d: StripesDraws, h: int, w: int) -> torch.Tensor:
    yy, xx = grid(h, w, d.theta.device)
    period = d.period * min(h, w)
    phase = (xx * _col(torch.cos(d.theta)) + yy * _col(torch.sin(d.theta))) / _col(period)
    t = (torch.sin(2 * math.pi * phase) > 0).float()[..., None]
    return d.c0[:, None, None, :] * t + d.c1[:, None, None, :] * (1.0 - t)


def _tex_gradient(d: GradientDraws, h: int, w: int) -> torch.Tensor:
    yy, xx = grid(h, w, d.theta.device)
    proj = xx * _col(torch.cos(d.theta)) + yy * _col(torch.sin(d.theta))
    lo = proj.amin(dim=(1, 2), keepdim=True)
    hi = proj.amax(dim=(1, 2), keepdim=True)
    t = (proj - lo) / torch.clamp(hi - lo, min=1e-6)
    c0, c1 = d.c0[:, None, None, :], d.c1[:, None, None, :]
    return c0 + t[..., None] * (c1 - c0)


def _tex_spectrum(d: SpectrumDraws, h: int, w: int) -> torch.Tensor:
    """White noise shaped to a 1/f^alpha amplitude spectrum, min-max
    normalised, through a two-colour ramp."""
    dev = d.alpha.device
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    amp = torch.clamp(f, min=1.0 / max(h, w))[None] ** (-_col(d.alpha))
    tex = torch.fft.irfft2(torch.fft.rfft2(d.white) * amp, s=(h, w))
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    t = (tex - lo) / torch.clamp(hi - lo, min=1e-6)
    c0, c1 = d.c0[:, None, None, :], d.c1[:, None, None, :]
    return c0 + t[..., None] * (c1 - c0)


def _by_family(pick: torch.Tensor, families, h: int, w: int) -> torch.Tensor:
    """(B, h, w, 3): scene i rendered by families[pick[i]] = (draws, render),
    each family for the scenes that picked it only."""
    out = torch.empty((pick.shape[0], h, w, 3), device=pick.device)
    for k, (draws, render) in enumerate(families):
        idx = torch.nonzero(pick == k).flatten()
        if idx.numel():
            out[idx] = render(take(draws, idx), h, w)
    return out


def _tex_photo(d: PhotoDraws, h: int, w: int) -> torch.Tensor:
    """A 1/f background and a second family behind a soft level set of
    smooth noise."""
    bg = _tex_spectrum(d.bg, h, w)
    fg = _by_family(d.pick, [(d.value_noise, _tex_value_noise), (d.voronoi, _tex_voronoi),
                             (d.stripes, _tex_stripes), (d.spectrum, _tex_spectrum)], h, w)
    m = torch.sigmoid((smooth_noise(d.boundary, h, w)[..., 0] - _col(d.level)) * 24.0)
    return bg * (1.0 - m[..., None]) + fg * m[..., None]


def texture(d: TextureDraws, h: int, w: int) -> torch.Tensor:
    """(B, h, w, 3): each scene's family; with photo draws, picks 4..7 all
    take the photo composite."""
    families = [(d.value_noise, _tex_value_noise), (d.voronoi, _tex_voronoi),
                (d.stripes, _tex_stripes), (d.gradient, _tex_gradient)]
    pick = d.pick
    if d.photo is not None:
        families.append((d.photo, _tex_photo))
        pick = torch.clamp(pick, max=4)
    return _by_family(pick, families, h, w)


# -- distractors and speculars ---------------------------------------------------

class RegionDraws(NamedTuple):
    cy: torch.Tensor      # (B, K) in [0.05, 0.95), times h
    cx: torch.Tensor      # times w
    sig_a: torch.Tensor   # in [sig_lo, sig_hi), times min(h, w)
    aspect: torch.Tensor  # in [1, 6)
    theta: torch.Tensor   # in [0, pi)
    p: torch.Tensor       # super-Gaussian exponent, in [p_lo, p_hi)


def region_draws(gen: torch.Generator, batch: int, n_max: int, sig_lo: float, sig_hi: float,
                 p_lo: float, p_hi: float) -> RegionDraws:
    s = (batch, n_max)
    return RegionDraws(cy=uniform(gen, s, 0.05, 0.95), cx=uniform(gen, s, 0.05, 0.95),
                       sig_a=uniform(gen, s, sig_lo, sig_hi), aspect=uniform(gen, s, 1.0, 6.0),
                       theta=uniform(gen, s, 0.0, math.pi), p=uniform(gen, s, p_lo, p_hi))


def _super_gaussians(cy, cx, sig_a, sig_b, theta, p, h: int, w: int) -> torch.Tensor:
    """(B, K, h, w) exp(-0.5 r^(p/2)), r the squared anisotropic radius."""
    yy, xx = grid(h, w, cy.device)
    ct, st = _col(torch.cos(theta)), _col(torch.sin(theta))
    dy = yy - _col(cy)
    dx = xx - _col(cx)
    u = dx * ct + dy * st
    v = -dx * st + dy * ct
    r = (u / _col(sig_a)) ** 2 + (v / _col(sig_b)) ** 2
    return torch.exp(-0.5 * r ** (_col(p) / 2.0))


def soft_regions(d: RegionDraws, h: int, w: int, n_active: torch.Tensor) -> torch.Tensor:
    """(B, K, h, w) super-Gaussian region weights in [0, 1]; regions >=
    n_active are zero."""
    sig_a = d.sig_a * min(h, w)
    sig_b = torch.clamp(sig_a / d.aspect, min=0.6)
    regions = _super_gaussians(d.cy * h, d.cx * w, sig_a, sig_b, d.theta, d.p, h, w)
    k = d.cy.shape[1]
    active = torch.arange(k, device=d.cy.device)[None, :] < n_active[:, None]
    return regions * _col(active)


class SpecularDRDraws(NamedTuple):
    n: torch.Tensor        # (B,) active lobes, in [1, MAX_LOBES + 1)
    regions: RegionDraws   # MAX_LOBES, sigma 0.015..0.11, p 1..6
    amp: torch.Tensor      # (B, MAX_LOBES) in [0.6, 3.0)
    bloom: torch.Tensor    # (B, MAX_LOBES) in [0, 0.18)


def specular_dr_draws(gen: torch.Generator, batch: int) -> SpecularDRDraws:
    return SpecularDRDraws(n=randint(gen, (batch,), 1, MAX_LOBES + 1),
                           regions=region_draws(gen, batch, MAX_LOBES, 0.015, 0.11, 1.0, 6.0),
                           amp=uniform(gen, (batch, MAX_LOBES), 0.6, 3.0),
                           bloom=uniform(gen, (batch, MAX_LOBES), 0.0, 0.18))


def specular_field_dr(d: SpecularDRDraws, h: int, w: int) -> torch.Tensor:
    """(B, h, w): super-Gaussian lobes plus a bloom skirt, regions^(1/9).
    Subnormal region weights are taken as 0, as XLA (and the TPU) flush
    them: the 1/9 power would lift one to ~6e-5."""
    regions = soft_regions(d.regions, h, w, d.n)
    regions = torch.where(regions >= _FLT_MIN, regions, torch.zeros_like(regions))
    skirt = regions ** (1.0 / 9.0)
    field = _col(d.amp) * regions + _col(d.amp * d.bloom) * skirt
    return field.sum(dim=1)


class GlintDraws(NamedTuple):
    n: torch.Tensor       # (B,) active glints, in [0, MAX_GLINTS + 1)
    ccy: torch.Tensor     # (B, N_GLINT_CLUSTERS) in [0.08, 0.92), times h
    ccx: torch.Tensor     # times w
    spread: torch.Tensor  # in [0.04, 0.30), times min(h, w)
    assign: torch.Tensor  # (B, MAX_GLINTS) cluster, in [0, N_GLINT_CLUSTERS)
    offs: torch.Tensor    # (B, MAX_GLINTS, 2) standard normal
    sig_a: torch.Tensor   # (B, MAX_GLINTS) in [0.6, 3.0) pixels
    aspect: torch.Tensor  # in [1, 4)
    theta: torch.Tensor   # in [0, pi)
    p: torch.Tensor       # in [1.5, 5)
    amp: torch.Tensor     # in [0.55, 2.6)


def glint_draws(gen: torch.Generator, batch: int) -> GlintDraws:
    c, g = (batch, N_GLINT_CLUSTERS), (batch, MAX_GLINTS)
    return GlintDraws(n=randint(gen, (batch,), 0, MAX_GLINTS + 1),
                      ccy=uniform(gen, c, 0.08, 0.92), ccx=uniform(gen, c, 0.08, 0.92),
                      spread=uniform(gen, c, 0.04, 0.30),
                      assign=randint(gen, g, 0, N_GLINT_CLUSTERS),
                      offs=torch.randn(g + (2,), generator=gen, device=gen.device),
                      sig_a=uniform(gen, g, 0.6, 3.0), aspect=uniform(gen, g, 1.0, 4.0),
                      theta=uniform(gen, g, 0.0, math.pi), p=uniform(gen, g, 1.5, 5.0),
                      amp=uniform(gen, g, 0.55, 2.6))


def glint_field(d: GlintDraws, h: int, w: int) -> torch.Tensor:
    """(B, h, w): tiny super-Gaussian spots scattered about their clusters."""
    ccy = torch.gather(d.ccy * h, 1, d.assign)
    ccx = torch.gather(d.ccx * w, 1, d.assign)
    spread = torch.gather(d.spread * min(h, w), 1, d.assign)
    cy = torch.clamp(ccy + d.offs[..., 0] * spread, 1.0, h - 2.0)
    cx = torch.clamp(ccx + d.offs[..., 1] * spread, 1.0, w - 2.0)
    sig_b = torch.clamp(d.sig_a / d.aspect, min=0.45)
    spots = _super_gaussians(cy, cx, d.sig_a, sig_b, d.theta, d.p, h, w)
    active = torch.arange(MAX_GLINTS, device=d.n.device)[None, :] < d.n[:, None]
    return (spots * _col(active) * _col(d.amp)).sum(dim=1)


# -- DR scenes -----------------------------------------------------------------------

class SceneDRDraws(NamedTuple):
    texture: TextureDraws
    n_d: torch.Tensor        # (B,) active distractors, in [0, MAX_DISTRACTORS + 1)
    distractors: RegionDraws  # MAX_DISTRACTORS, sigma 0.12..0.45, p 1..4
    strength: torch.Tensor   # (B, MAX_DISTRACTORS) in [0.45, 0.9)
    exposure: torch.Tensor   # (B,) in [0.75, 1.15)
    gamma: torch.Tensor      # (B,) in [0.75, 1.4)
    vignette: torch.Tensor   # (B,) in [0, 0.35)
    spec: SpecularDRDraws
    glints: Optional[GlintDraws]  # dr2, dr3
    tint: torch.Tensor       # (B, 3) in [0, 0.08): the tint is 1 - it
    nsig: torch.Tensor       # (B,) sensor noise stddev, in [0, 0.02)
    noise: torch.Tensor      # (B, h, w, 3) standard normal


def synth_scene_dr_draws(gen: torch.Generator, batch: int, h: int, w: int,
                         glints: bool = False, photo: bool = False) -> SceneDRDraws:
    return SceneDRDraws(
        texture=texture_draws(gen, batch, h, w, photo),
        n_d=randint(gen, (batch,), 0, MAX_DISTRACTORS + 1),
        distractors=region_draws(gen, batch, MAX_DISTRACTORS, 0.12, 0.45, 1.0, 4.0),
        strength=uniform(gen, (batch, MAX_DISTRACTORS), 0.45, 0.9),
        exposure=uniform(gen, (batch,), 0.75, 1.15), gamma=uniform(gen, (batch,), 0.75, 1.4),
        vignette=uniform(gen, (batch,), 0.0, 0.35), spec=specular_dr_draws(gen, batch),
        glints=glint_draws(gen, batch) if glints else None,
        tint=uniform(gen, (batch, 3), 0.0, 0.08), nsig=uniform(gen, (batch,), 0.0, 0.02),
        noise=torch.randn((batch, h, w, 3), generator=gen, device=gen.device))


def scene_dr_parts(d: SceneDRDraws, h: int, w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A DR scene's layers before the composite: (diffuse (B, h, w, 3),
    specular field (B, h, w), tint (B, 3))."""
    base = texture(d.texture, h, w)
    dreg = soft_regions(d.distractors, h, w, d.n_d)
    v = torch.clamp((dreg * _col(d.strength)).sum(dim=1), 0.0, 0.95)
    base = 1.0 - (1.0 - base) * (1.0 - v[..., None])

    yy, xx = grid(h, w, base.device)
    r2 = ((yy / h - 0.5) ** 2 + (xx / w - 0.5) ** 2) / 0.5
    vig = 1.0 - _col(d.vignette) * r2
    lit = torch.clamp(base * d.exposure[:, None, None, None] * vig[..., None], 0.0, 1.0)
    diffuse = lit ** d.gamma[:, None, None, None]

    spec = specular_field_dr(d.spec, h, w)
    if d.glints is not None:
        spec = spec + glint_field(d.glints, h, w)
    return diffuse, spec, 1.0 - d.tint


def synth_scene_dr(d: SceneDRDraws, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(camera (B, h, w, 3) in [0, 1], mask (B, h, w, 1)): the photometric
    diffuse scene plus the tinted specular plus sensor noise, clipped; the
    mask is the specular field alone."""
    diffuse, spec, tint = scene_dr_parts(d, h, w)
    camera = diffuse + spec[..., None] * tint[:, None, None, :]
    camera = camera + d.nsig[:, None, None, None] * d.noise
    camera = torch.clamp(camera, 0.0, 1.0)
    return camera, (spec > 0.25).float()[..., None]


# -- the GAN phase's DR views -------------------------------------------------------

class SceneViewsDRDraws(NamedTuple):
    scene: SceneDRDraws      # photo off; its `noise` is the camera image's noise
    phi: torch.Tensor        # (B,) polariser phase, in [0, pi)
    pol_frac: torch.Tensor   # (B,) in [0.6, 0.95)
    view_noise: torch.Tensor  # (B, 4, h, w, 3) standard normal, one field a view


def synth_scene_views_dr_draws(gen: torch.Generator, batch: int, h: int, w: int,
                               glints: bool = True) -> SceneViewsDRDraws:
    return SceneViewsDRDraws(
        scene=synth_scene_dr_draws(gen, batch, h, w, glints),
        phi=uniform(gen, (batch,), 0.0, math.pi), pol_frac=uniform(gen, (batch,), 0.6, 0.95),
        view_noise=torch.randn((batch, 4, h, w, 3), generator=gen, device=gen.device))


def synth_scene_views_dr(d: SceneViewsDRDraws, h: int, w: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (views (B, 4, h, w, 3), diffuse (B, h, w, 3), mask (B, h, w, 1),
    camera (B, h, w, 3)): the DR scene's diffuse layer shared by the views,
    its tinted specular through each view's Malus gain, each view and the
    camera image (the specular at its strongest view) with their own sensor
    noise, clipped; the mask is the specular field > 0.25."""
    diffuse, spec, tint = scene_dr_parts(d.scene, h, w)
    angles = torch.tensor(VIEW_ANGLES_RAD, device=spec.device)
    pol = d.pol_frac[:, None]
    gains = (1 - pol) * 0.5 + pol * torch.cos(angles[None, :] - d.phi[:, None]) ** 2  # (B, 4)
    spec_rgb = spec[..., None] * tint[:, None, None, :]
    nsig = d.scene.nsig[:, None, None, None]
    views = diffuse[:, None] + spec_rgb[:, None] * gains[:, :, None, None, None]
    views = torch.clamp(views + nsig[:, None] * d.view_noise, 0.0, 1.0)
    camera = diffuse + spec_rgb * gains.amax(dim=1)[:, None, None, None]
    camera = torch.clamp(camera + nsig * d.scene.noise, 0.0, 1.0)
    return views, diffuse, (spec > 0.25).float()[..., None], camera


class ViewsBatchDRDraws(NamedTuple):
    base: Optional[ViewsDraws]         # floor(batch * base_mix) base-curriculum stacks
    dr: Optional[SceneViewsDRDraws]    # the rest
    swap_u: Optional[torch.Tensor]     # (n_dr,) the DR stacks' camera swap, as ViewsDraws'
    swap_slot: Optional[torch.Tensor]


def synth_views_batch_dr_draws(gen: torch.Generator, batch: int, h: int, w: int,
                               base_mix: float = 0.5, glints: bool = True) -> ViewsBatchDRDraws:
    n_base = int(batch * base_mix)
    n_dr = batch - n_base
    base = synth_views_batch_draws(gen, n_base, h, w) if n_base > 0 else None
    if n_dr == 0:
        return ViewsBatchDRDraws(base, None, None, None)
    return ViewsBatchDRDraws(base, synth_scene_views_dr_draws(gen, n_dr, h, w, glints),
                             uniform(gen, (n_dr,)), randint(gen, (n_dr,), 0, 4))


def synth_views_batch_dr_render(d: ViewsBatchDRDraws, h: int, w: int, ed_mode: str = "min",
                                camera_swap_prob: float = 0.0) -> torch.Tensor:
    """(5, B, h, w, 3): the base stacks, then the DR stacks, each the 4 views
    (a camera image in place of one view with probability camera_swap_prob)
    and ED, the views' channel-wise min ("min") or the diffuse layer
    ("diffuse")."""
    parts = []
    if d.base is not None:
        parts.append(synth_views_batch_render(d.base, h, w, ed_mode, camera_swap_prob))
    if d.dr is not None:
        views, diffuse, _, camera = synth_scene_views_dr(d.dr, h, w)
        views = swap_camera(views.movedim(1, 0), camera, d.swap_u, d.swap_slot,
                            camera_swap_prob)
        ed = diffuse if ed_mode == "diffuse" else views.amin(dim=0)
        parts.append(torch.cat([views, ed[None]], dim=0))
    return torch.cat(parts, dim=1)


def synth_views_batch_dr(gen: torch.Generator, batch: int, h: int, w: int,
                         ed_mode: str = "min", camera_swap_prob: float = 0.0,
                         base_mix: float = 0.5, glints: bool = True) -> torch.Tensor:
    return synth_views_batch_dr_render(
        synth_views_batch_dr_draws(gen, batch, h, w, base_mix, glints), h, w, ed_mode,
        camera_swap_prob)


# -- SpecSeg batches ------------------------------------------------------------------

class SpecSegDRDraws(NamedTuple):
    base: Optional[RGBDraws]      # floor(batch * base_mix) base-curriculum scenes
    dr: Optional[SceneDRDraws]    # the rest


def synth_specseg_batch_dr_draws(gen: torch.Generator, batch: int, h: int, w: int,
                                 base_mix: float = 0.5, glints: bool = False,
                                 photo: bool = False) -> SpecSegDRDraws:
    n_base = int(batch * base_mix)
    n_dr = batch - n_base
    return SpecSegDRDraws(
        base=synth_specseg_rgb_batch_draws(gen, n_base, h, w) if n_base > 0 else None,
        dr=synth_scene_dr_draws(gen, n_dr, h, w, glints, photo) if n_dr > 0 else None)


def _rgb_and_masks(d: SpecSegDRDraws, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    parts = []
    if d.base is not None:
        parts.append(synth_specseg_rgb_batch_render(d.base, h, w))
    if d.dr is not None:
        parts.append(synth_scene_dr(d.dr, h, w))
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def synth_specseg_batch_dr_render(d: SpecSegDRDraws, h: int, w: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(standardised Y (B, h, w, 1), mask (B, h, w, 1)): the base scenes'
    five-domain pick first, then the DR camera scenes."""
    rgb, mask = _rgb_and_masks(d, h, w)
    return standardized_luma(rgb), mask


def synth_specseg_batch_dr_chroma_render(d: SpecSegDRDraws, h: int, w: int
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, h, w, 2) [standardised Y | chroma prior], mask (B, h, w, 1)):
    the input a 2-channel SpecSeg takes (ops/specprior.specseg_net_input)."""
    rgb, mask = _rgb_and_masks(d, h, w)
    return specseg_net_input(standardized_luma(rgb), rgb, 2), mask


def synth_specseg_batch_dr(gen: torch.Generator, batch: int, h: int, w: int,
                           base_mix: float = 0.5, glints: bool = False, photo: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return synth_specseg_batch_dr_render(
        synth_specseg_batch_dr_draws(gen, batch, h, w, base_mix, glints, photo), h, w)


def synth_specseg_batch_dr_chroma(gen: torch.Generator, batch: int, h: int, w: int,
                                  base_mix: float = 0.5, glints: bool = False,
                                  photo: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    return synth_specseg_batch_dr_chroma_render(
        synth_specseg_batch_dr_draws(gen, batch, h, w, base_mix, glints, photo), h, w)

