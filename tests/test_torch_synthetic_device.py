"""The port's on-device curricula (data/synthetic_device.py, the SpecSeg half
of data/synthetic_dr.py) against the JAX package's (data/synthetic_jax.py,
data/synthetic_dr.py), on the CPU at 32 px.

The two frameworks' PRNGs differ, so the renders are held on JAX's own draws:
the helpers below take each JAX generator's key through the same splits and
draws as the JAX module, lay the draws out as the port's NamedTuples, and the
port renders them. The port's own draws are held to JAX's in distribution.

Tolerances:
  - RGB renders within ATOL 1e-5 (float32, the same operations; XLA and torch
    round exp, pow and sums in their own way: measured 2.4e-7 at worst) at
    all but MAX_EDGE_PIXELS pixels a batch, where a hard edge (a Voronoi
    distance tie, a stripe's sign, the 0.25 mask threshold) may fall either
    way; masks likewise;
  - the 1/f spectrum texture within SPECTRUM_ATOL 1e-5: torch's FFT rounds
    otherwise than XLA's, and the min-max normalisation keeps that small;
  - standardised Y within rtol 5e-5: its per-image scale is a difference of
    two float32 means over h*w values, E[y^2] - E[y]^2, summed in another
    order (measured 1.4e-5);
  - in distribution: each statistic of 256 port scenes within 4 standard
    errors of 256 JAX scenes'.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shmgan_tpu.data import synthetic_dr as JDR
from shmgan_tpu.data import synthetic_jax as J
from shmgan_tpu_torch.data import synthetic_device as S
from shmgan_tpu_torch.data import synthetic_dr as DR

H = W = 32
ATOL = 1e-5
SPECTRUM_ATOL = 1e-5
STD_RTOL = 5e-5
MAX_EDGE_PIXELS = 4
U = jax.random.uniform


def t(x):
    return torch.from_numpy(np.array(x))


def tree(cls, *xs):
    """A port NamedTuple from JAX arrays (nested tuples stay tuples)."""
    conv = lambda x: tuple(t(g) for g in x) if isinstance(x, tuple) else x  # noqa: E731
    return cls(*[conv(x) if not isinstance(x, (jax.Array, np.ndarray)) else t(x) for x in xs])


# -- JAX's draws, by the JAX module's own key splits ---------------------------------

def j_noise(key, c):
    keys = jax.random.split(key, 4)
    return tuple(U(keys[o], (gh, gw, c), jnp.float32)
                 for o, (gh, gw) in enumerate(J._octave_sizes(H, W, 4)))


def j_lobes(key):
    ks = jax.random.split(key, 8)
    L = J.MAX_LOBES
    return (jax.random.randint(ks[0], (), 2, L + 1), U(ks[1], (L,), minval=0.1, maxval=0.9),
            U(ks[2], (L,), minval=0.1, maxval=0.9), U(ks[3], (L,), minval=0.025, maxval=0.11),
            U(ks[4], (L,), minval=1.0, maxval=4.0), U(ks[5], (L,), minval=0.0, maxval=jnp.pi),
            U(ks[6], (L,), minval=0.7, maxval=2.4))


def j_scene(key):
    k_diff, k_spec, k_tint, k_phi, k_pol = jax.random.split(key, 5)
    return (j_noise(k_diff, 3), j_lobes(k_spec), U(k_tint, (3,), minval=0.0, maxval=0.12),
            U(k_phi, (), minval=0.0, maxval=jnp.pi), U(k_pol, (), minval=0.6, maxval=0.95))


def scene_tree(raw):
    noise, lobes, tint, phi, pol = raw
    return S.SceneDraws(tuple(t(g) for g in noise), tree(S.LobeDraws, *lobes), t(tint), t(phi),
                        t(pol))


def j_views(key, batch):
    k_scenes, k_swap = jax.random.split(key)
    k_u, k_slot = jax.random.split(k_swap)
    return (jax.vmap(j_scene)(jax.random.split(k_scenes, batch)), U(k_u, (batch,)),
            jax.random.randint(k_slot, (batch,), 0, 4))


def j_rgb(key, batch):
    k_scenes, k_pick = jax.random.split(key)
    return (jax.vmap(j_scene)(jax.random.split(k_scenes, batch)),
            jax.random.randint(k_pick, (batch,), 0, 5))


def rgb_tree(raw):
    return S.RGBDraws(scene_tree(raw[0]), t(raw[1]))


def j_value_noise(key):
    k_n, k_lo, k_hi = jax.random.split(key, 3)
    return (j_noise(k_n, 3), U(k_lo, (), minval=0.02, maxval=0.25),
            U(k_hi, (), minval=0.6, maxval=0.97))


def j_voronoi(key):
    k_y, k_x, k_c = jax.random.split(key, 3)
    n = JDR.N_VORONOI
    return U(k_y, (n,)), U(k_x, (n,)), U(k_c, (n, 3), minval=0.05, maxval=0.95)


def j_stripes(key):
    k_t, k_p, k_c0, k_c1 = jax.random.split(key, 4)
    return (U(k_t, (), minval=0.0, maxval=jnp.pi), U(k_p, (), minval=0.08, maxval=0.35),
            U(k_c0, (3,), minval=0.05, maxval=0.92), U(k_c1, (3,), minval=0.05, maxval=0.92))


def j_gradient(key):
    k_t, k_c0, k_c1 = jax.random.split(key, 3)
    return (U(k_t, (), minval=0.0, maxval=2 * jnp.pi), U(k_c0, (3,), minval=0.03, maxval=0.95),
            U(k_c1, (3,), minval=0.03, maxval=0.95))


def j_spectrum(key):
    k_n, k_a, k_c0, k_c1 = jax.random.split(key, 4)
    return (U(k_a, (), minval=0.8, maxval=1.8), jax.random.normal(k_n, (H, W)),
            U(k_c0, (3,), minval=0.02, maxval=0.55), U(k_c1, (3,), minval=0.4, maxval=0.97))


def j_photo(key):
    k_bg, k_fg, k_pick, k_m, k_lv = jax.random.split(key, 5)
    # every foreground family from k_fg: the render reads the one picked
    return (j_spectrum(k_bg), jax.random.randint(k_pick, (), 0, 4), j_value_noise(k_fg),
            j_voronoi(k_fg), j_stripes(k_fg), j_spectrum(k_fg),
            U(k_lv, (), minval=0.35, maxval=0.65), j_noise(k_m, 1))


def j_texture(key, photo):
    k_pick, k_tex = jax.random.split(key)
    return (jax.random.randint(k_pick, (), 0, 8 if photo else 4), j_value_noise(k_tex),
            j_voronoi(k_tex), j_stripes(k_tex), j_gradient(k_tex),
            j_photo(k_tex) if photo else None)


def photo_tree(ph):
    return DR.PhotoDraws(tree(DR.SpectrumDraws, *ph[0]), t(ph[1]),
                         tree(DR.ValueNoiseDraws, *ph[2]), tree(DR.VoronoiDraws, *ph[3]),
                         tree(DR.StripesDraws, *ph[4]), tree(DR.SpectrumDraws, *ph[5]),
                         t(ph[6]), tuple(t(g) for g in ph[7]))


def texture_tree(d):
    pick, vn, vor, st, gr, ph = d
    return DR.TextureDraws(t(pick), tree(DR.ValueNoiseDraws, *vn), tree(DR.VoronoiDraws, *vor),
                           tree(DR.StripesDraws, *st), tree(DR.GradientDraws, *gr),
                           photo_tree(ph) if ph is not None else None)


def j_regions(key, n, sig_lo, sig_hi, p_lo, p_hi):
    ks = jax.random.split(key, 6)
    return (U(ks[0], (n,), minval=0.05, maxval=0.95), U(ks[1], (n,), minval=0.05, maxval=0.95),
            U(ks[2], (n,), minval=sig_lo, maxval=sig_hi), U(ks[3], (n,), minval=1.0, maxval=6.0),
            U(ks[4], (n,), minval=0.0, maxval=jnp.pi), U(ks[5], (n,), minval=p_lo, maxval=p_hi))


def j_spec_dr(key):
    k_n, k_reg, k_amp, k_bloom = jax.random.split(key, 4)
    L = JDR.MAX_LOBES
    return (jax.random.randint(k_n, (), 1, L + 1), j_regions(k_reg, L, 0.015, 0.11, 1.0, 6.0),
            U(k_amp, (L,), minval=0.6, maxval=3.0), U(k_bloom, (L,), minval=0.0, maxval=0.18))


def j_glints(key):
    ks = jax.random.split(key, 11)
    c, g = (JDR.N_GLINT_CLUSTERS,), (JDR.MAX_GLINTS,)
    return (jax.random.randint(ks[0], (), 0, JDR.MAX_GLINTS + 1),
            U(ks[1], c, minval=0.08, maxval=0.92), U(ks[2], c, minval=0.08, maxval=0.92),
            U(ks[3], c, minval=0.04, maxval=0.30),
            jax.random.randint(ks[4], g, 0, JDR.N_GLINT_CLUSTERS),
            jax.random.normal(ks[5], g + (2,)), U(ks[6], g, minval=0.6, maxval=3.0),
            U(ks[7], g, minval=1.0, maxval=4.0), U(ks[8], g, minval=0.0, maxval=jnp.pi),
            U(ks[9], g, minval=1.5, maxval=5.0), U(ks[10], g, minval=0.55, maxval=2.6))


def j_scene_dr(key, glints, photo):
    (k_tex, k_nd, k_dreg, k_ds, k_spec, k_tint, k_exp, k_gam, k_vig, k_nsig, k_noise,
     k_glint) = jax.random.split(key, 12)
    return (j_texture(k_tex, photo), jax.random.randint(k_nd, (), 0, JDR.MAX_DISTRACTORS + 1),
            j_regions(k_dreg, JDR.MAX_DISTRACTORS, 0.12, 0.45, 1.0, 4.0),
            U(k_ds, (JDR.MAX_DISTRACTORS,), minval=0.45, maxval=0.9),
            U(k_exp, (), minval=0.75, maxval=1.15), U(k_gam, (), minval=0.75, maxval=1.4),
            U(k_vig, (), minval=0.0, maxval=0.35), j_spec_dr(k_spec),
            j_glints(k_glint) if glints else None, U(k_tint, (3,), minval=0.0, maxval=0.08),
            U(k_nsig, (), minval=0.0, maxval=0.02), jax.random.normal(k_noise, (H, W, 3)))


def scene_dr_tree(d):
    n_spec, regions, amp, bloom = d[7]
    return DR.SceneDRDraws(
        texture_tree(d[0]), t(d[1]), tree(DR.RegionDraws, *d[2]), t(d[3]), t(d[4]), t(d[5]),
        t(d[6]), DR.SpecularDRDraws(t(n_spec), tree(DR.RegionDraws, *regions), t(amp), t(bloom)),
        tree(DR.GlintDraws, *d[8]) if d[8] is not None else None, t(d[9]), t(d[10]), t(d[11]))


def j_specseg_dr(key, batch, base_mix, glints, photo):
    n_base = int(batch * base_mix)
    k_base, k_dr = jax.random.split(key)
    return (j_rgb(k_base, n_base) if n_base else None,
            jax.vmap(lambda k: j_scene_dr(k, glints, photo))(
                jax.random.split(k_dr, batch - n_base)) if batch > n_base else None)


def specseg_dr_tree(raw):
    return DR.SpecSegDRDraws(base=rgb_tree(raw[0]) if raw[0] is not None else None,
                             dr=scene_dr_tree(raw[1]) if raw[1] is not None else None)


def compiled(fn):
    """fn() jitted and run: one XLA program compiled with LLVM's backend
    optimisation off (it halves the compile, which is most of the time here;
    every test's tolerance holds at either level)."""
    lowered = jax.jit(fn).lower()
    out = lowered.compile(compiler_options={"xla_backend_optimization_level": 0,
                                            "xla_llvm_disable_expensive_passes": True})()
    return jax.tree_util.tree_map(np.asarray, out)


# -- comparisons ------------------------------------------------------------------

def assert_image(got, ref, atol=ATOL, label=""):
    """Within atol at all but MAX_EDGE_PIXELS pixels (a pixel: every channel)."""
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bad = (np.abs(got - ref) > atol).reshape(-1, got.shape[-1]).any(axis=1)
    assert bad.sum() <= MAX_EDGE_PIXELS, (label, int(bad.sum()), np.abs(got - ref).max())


def assert_standardized(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    scale = np.abs(ref).max(axis=tuple(range(1, ref.ndim)), keepdims=True)
    bad = (np.abs(got - ref) > STD_RTOL * scale).reshape(-1, got.shape[-1]).any(axis=1)
    assert bad.sum() <= MAX_EDGE_PIXELS, (int(bad.sum()), (np.abs(got - ref) / scale).max())


# -- base curriculum ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 3), (4, 4, 1), (16, 16, 3), (3, 5, 2)])
def test_bilinear_upsampling_is_jax_linear_resize(shape):
    """jax.image.resize(method="linear") upsampling = F.interpolate(bilinear,
    align_corners=False, antialias=False): half-pixel centres, the edge
    clamped (also at a scale that is not an integer)."""
    coarse = np.random.default_rng(0).random(shape, np.float32)
    for size in ((H, W), (24, 40)):
        ref = jax.image.resize(jnp.asarray(coarse), size + (shape[2],), method="linear")
        got = F.interpolate(t(coarse).permute(2, 0, 1)[None], size=size, mode="bilinear",
                            align_corners=False, antialias=False)[0].permute(1, 2, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


N_DIST = 256


@pytest.fixture(scope="module")
def jbase():
    """The JAX side of every base-curriculum test, one program: each
    generator's draws and its outputs on the same keys."""
    def fn():
        k1 = jax.random.split(jax.random.PRNGKey(1), 3)
        k2, k3, k4 = jax.random.PRNGKey(2), jax.random.PRNGKey(3), jax.random.PRNGKey(4)
        k_dist = jax.random.split(jax.random.PRNGKey(11), N_DIST)
        return {
            "scene_draws": jax.vmap(j_scene)(k1),
            "noise": jax.vmap(lambda k: J.smooth_noise(jax.random.split(k, 5)[0], H, W, 3))(k1),
            "field": jax.vmap(lambda k: J.specular_field(jax.random.split(k, 5)[1], H, W))(k1),
            "scene": jax.vmap(lambda k: J.synth_scene(k, H, W))(k1),
            "views_draws": j_views(k2, 4),
            "views": {m: J.synth_views_batch(k2, 4, H, W, ed_mode=m, camera_swap_prob=0.5)
                      for m in ("min", "diffuse")},
            "rgb_draws": j_rgb(k3, 4), "rgb": J.synth_specseg_rgb_batch(k3, 4, H, W),
            "specseg": J.synth_specseg_batch(k3, 4, H, W),
            "eval_draws": jax.vmap(j_scene)(jax.random.split(k4, 3)),
            "eval": J.synth_eval_batch(k4, 3, H, W),
            "dist": jax.vmap(lambda k: J.synth_scene(k, H, W))(k_dist)[2:],
            "dist_lobes": jax.vmap(j_scene)(k_dist)[1][0],
        }
    return compiled(fn)


def test_smooth_noise_and_synth_scene_on_jax_draws(jbase):
    d = scene_tree(jbase["scene_draws"])
    assert_image(S.smooth_noise(d.noise, H, W), jbase["noise"])
    assert_image(S.specular_field(d.lobes, H, W)[..., None], jbase["field"][..., None])
    got = S.synth_scene(d, H, W)
    for name, g, r in zip(("views", "diffuse", "mask", "camera"), got, jbase["scene"]):
        assert_image(g, r, label=name)


@pytest.mark.parametrize("ed_mode", ["min", "diffuse"])
def test_synth_views_batch_on_jax_draws(jbase, ed_mode):
    raw = jbase["views_draws"]
    d = S.ViewsDraws(scene_tree(raw[0]), t(raw[1]), t(raw[2]))
    assert (d.swap_u < 0.5).any() and (d.swap_u >= 0.5).any()
    assert_image(S.synth_views_batch_render(d, H, W, ed_mode, 0.5), jbase["views"][ed_mode])


def test_synth_specseg_batches_on_jax_draws(jbase):
    d = rgb_tree(jbase["rgb_draws"])
    rgb, mask = S.synth_specseg_rgb_batch_render(d, H, W)
    assert_image(rgb, jbase["rgb"][0])
    assert_image(mask, jbase["rgb"][1])
    y, mask = S.synth_specseg_batch_render(d, H, W)
    assert_standardized(y, jbase["specseg"][0])
    assert_image(mask, jbase["specseg"][1])


def test_synth_eval_batch_on_jax_draws(jbase):
    got = S.synth_eval_batch_render(scene_tree(jbase["eval_draws"]), H, W)
    for g, r in zip(got, jbase["eval"]):
        assert_image(g, r)


# -- DR curriculum --------------------------------------------------------------------

FAMILIES = {
    "value_noise": (j_value_noise, DR.ValueNoiseDraws, DR._tex_value_noise,
                    JDR._tex_value_noise),
    "voronoi": (j_voronoi, DR.VoronoiDraws, DR._tex_voronoi, JDR._tex_voronoi),
    "stripes": (j_stripes, DR.StripesDraws, DR._tex_stripes, JDR._tex_stripes),
    "gradient": (j_gradient, DR.GradientDraws, DR._tex_gradient, JDR._tex_gradient),
    "spectrum": (j_spectrum, DR.SpectrumDraws, DR._tex_spectrum, JDR._tex_spectrum),
}


SCENE_DR_CASES = [(False, False), (True, False), (False, True), (True, True)]
SPECSEG_DR_CASES = [(1.0, False), (0.5, False), (1.0, True), (0.5, True)]


@pytest.fixture(scope="module")
def jdr():
    """The JAX side of every DR test, one program."""
    def fn():
        k5 = jax.random.split(jax.random.PRNGKey(5), 8)
        k7 = jax.random.split(jax.random.PRNGKey(7), 6)
        k8 = jax.random.PRNGKey(8)
        k_dist = jax.random.split(jax.random.PRNGKey(12), N_DIST)
        out = {"family": {f: (jax.vmap(draw)(k5),
                              jax.vmap(lambda k, fn=jax_fn: fn(k, H, W))(k5))
                          for f, (draw, _, _, jax_fn) in FAMILIES.items()}}
        out["family"]["photo"] = (jax.vmap(j_photo)(k5),
                                  jax.vmap(lambda k: JDR._tex_photo(k, H, W))(k5))
        out["scene_dr"] = {
            c: (jax.vmap(lambda k: j_scene_dr(k, *c))(k7),
                jax.vmap(lambda k: JDR.synth_scene_dr(k, H, W, glints=c[0], photo=c[1]))(k7))
            for c in SCENE_DR_CASES}
        out["specseg_dr"] = {}
        for mix, chroma in SPECSEG_DR_CASES:
            batch_fn = JDR.synth_specseg_batch_dr_chroma if chroma else JDR.synth_specseg_batch_dr
            out["specseg_dr"][mix, chroma] = (j_specseg_dr(k8, 4, mix, True, False),
                                              batch_fn(k8, 4, H, W, base_mix=mix, glints=True))
        dist = jax.vmap(lambda k: JDR.synth_scene_dr(k, H, W, glints=True, photo=True))(k_dist)
        draws = jax.vmap(lambda k: j_scene_dr(k, True, True))(k_dist)
        out["dist"] = (dist, draws[7][0], draws[8][0], jnp.minimum(draws[0][0], 4))
        return out
    return compiled(fn)


@pytest.mark.parametrize("family", list(FAMILIES) + ["photo"])
def test_texture_family_on_jax_draws(jdr, family):
    raw, ref = jdr["family"][family]
    if family == "photo":
        draws = photo_tree(raw)
        got = DR._tex_photo(draws, H, W)
        assert set(draws.pick.tolist()) == {0, 1, 2, 3}
    else:
        _, cls, port, _ = FAMILIES[family]
        got = port(tree(cls, *raw), H, W)
    atol = SPECTRUM_ATOL if family in ("spectrum", "photo") else ATOL
    assert_image(got, ref, atol=atol)


@pytest.mark.parametrize("glints,photo", SCENE_DR_CASES)
def test_synth_scene_dr_on_jax_draws(jdr, glints, photo):
    raw, (j_cam, j_mask) = jdr["scene_dr"][glints, photo]
    d = scene_dr_tree(raw)
    cam, mask = DR.synth_scene_dr(d, H, W)
    assert_image(cam, j_cam, atol=SPECTRUM_ATOL)
    assert_image(mask, j_mask)
    assert mask.sum() > 0 and (d.n_d > 0).any()
    if photo:
        assert (d.texture.pick >= 4).any()


@pytest.mark.parametrize("base_mix,chroma", SPECSEG_DR_CASES)
def test_synth_specseg_batch_dr_on_jax_draws(jdr, base_mix, chroma):
    raw, ref = jdr["specseg_dr"][base_mix, chroma]
    d = specseg_dr_tree(raw)
    if chroma:
        got = DR.synth_specseg_batch_dr_chroma_render(d, H, W)
        assert got[0].shape == (4, H, W, 2)
        assert_image(got[0][..., 1:], ref[0][..., 1:], label="prior")
        got, ref = (got[0][..., :1], got[1]), (ref[0][..., :1], ref[1])
    else:
        got = DR.synth_specseg_batch_dr_render(d, H, W)
    assert_standardized(got[0], ref[0])
    assert_image(got[1], ref[1])


def test_gan_phase_dr_views_raise():
    """The GAN phase's DR views on the port's own draws (held against JAX's
    renders in tests/test_torch_quality_gan.py): floor(batch * base_mix)
    base stacks first, each the base curriculum's render of its draws; ED
    the views' min or the diffuse layer; every DR view within the sensor
    noise of the diffuse layer plus its Malus-gained specular."""
    g = torch.Generator().manual_seed(3)
    d = DR.synth_views_batch_dr_draws(g, 5, H, W, base_mix=0.5)
    assert d.base.swap_u.shape == (2,) and d.dr.phi.shape == d.swap_u.shape == (3,)
    views = {m: DR.synth_views_batch_dr_render(d, H, W, m, 0.0) for m in ("min", "diffuse")}
    assert views["min"].shape == (5, 5, H, W, 3)
    assert torch.equal(views["min"][:, :2], S.synth_views_batch_render(d.base, H, W, "min"))
    assert torch.equal(views["min"][4], views["min"][:4].amin(dim=0))
    four, diffuse, _, _ = DR.synth_scene_views_dr(d.dr, H, W)
    assert torch.equal(views["diffuse"][4, 2:], diffuse)
    assert torch.equal(views["diffuse"][:4, 2:], four.movedim(1, 0))
    clean = torch.clamp(four - d.dr.scene.nsig[:, None, None, None, None] * d.dr.view_noise,
                        0.0, 1.0)
    assert (clean >= diffuse[:, None] - 1e-6).all()
    assert views["diffuse"].min() >= 0.0 and views["diffuse"].max() <= 1.0
    all_base = DR.synth_views_batch_dr_draws(g, 4, H, W, base_mix=1.0)
    assert all_base.dr is None and all_base.swap_u is None


# -- the port's own draws, in distribution ------------------------------------------

def _stats(rgb, mask):
    """Per-scene statistics: mask coverage and mean pixel."""
    return {"coverage": mask.reshape(mask.shape[0], -1).mean(1),
            "mean_pixel": rgb.reshape(rgb.shape[0], -1).mean(1)}


def _within(port, ref, label):
    for k in ref:
        a, b = np.asarray(port[k], np.float64), np.asarray(ref[k], np.float64)
        se = math.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 4 * se, (label, k, a.mean(), b.mean(), se)


def test_base_draws_in_distribution(jbase):
    g = torch.Generator().manual_seed(0)
    d = S.synth_scene_draws(g, N_DIST, H, W)
    _, _, mask, cam = S.synth_scene(d, H, W)
    port = {**_stats(cam, mask), "lobes": d.lobes.n.numpy()}
    j_mask, j_cam = jbase["dist"]
    _within(port, {**_stats(j_cam, j_mask), "lobes": jbase["dist_lobes"]}, "base")
    assert set(d.lobes.n.tolist()) == set(range(2, 8))


def test_dr_draws_in_distribution(jdr):
    g = torch.Generator().manual_seed(0)
    d = DR.synth_scene_dr_draws(g, N_DIST, H, W, glints=True, photo=True)
    cam, mask = DR.synth_scene_dr(d, H, W)
    port = {**_stats(cam, mask), "lobes": d.spec.n.numpy(), "glints": d.glints.n.numpy(),
            "family": torch.clamp(d.texture.pick, max=4).numpy()}
    (j_cam, j_mask), lobes, glints, family = jdr["dist"]
    _within(port, {**_stats(j_cam, j_mask), "lobes": lobes, "glints": glints,
                   "family": family}, "dr")
