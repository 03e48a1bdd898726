"""Phase B of the flagship trainer on the port (shmgan_tpu_torch/quality_train.py
`--phase gan|both`) against the JAX package's (examples/quality_train.py), on
the CPU: the GAN phase's DR views, the SpecSeg-feature FID and the inception
score (eval/fid.py), `transfer_matching_params`, the image grid, the
best-checkpoint gate, the held-out oracle, and the trainer end to end.

Sizes: 64 px, filter 8, SpecSeg base 4, batch 2, float32 (the DR views at the
32 px of tests/test_torch_synthetic_device.py, whose helpers rebuild JAX's
draws by the JAX module's key splits). Weights are seeded and converted, at
scales (0.1 for G, 0.2 for SpecSeg) where SpecSeg's features are far from
zero. JAX's train state comes from `jax.eval_shape` leaves, and the JAX
trainer run that gives the reference keys takes a stub step and a stub
inference (its compile would take minutes here); its gate, history, files
and FID chain are its own.

Tolerances:
  - DR renders within 1e-5 at all but 4 edge pixels a batch (the base
    curriculum's rule);
  - FID within 1e-4 of tr Sa + tr Sb: the trace terms cancel; with fewer
    samples than features the covariances are singular and two float32
    eigensolvers part in their null space, so FIDs of network features at
    N < D also take that space's rounding (`fid_tolerance`);
  - SpecSeg features within 5e-5 of their largest magnitude: their input,
    the standardised Y, is a ratio whose scale is a difference of two float32
    means summed in another order, held within 5e-5 in
    tests/test_torch_synthetic_device.py (here it read 1.2e-5, the features
    5.3e-6 and 1.2e-5); the inception score within 1e-6 relative;
  - the oracle's per-image PSNR within 1e-3 dB and SSIM within 1e-4 (the
    calibrated output within make_infer_fn's 1e-3 parity), per-draw FID by
    `fid_tolerance`.
"""

import dataclasses
import importlib.util
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_synthetic_device as tsd
from shmgan_tpu import checkpoint as j_checkpoint
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.data import synthetic_dr as JDR
from shmgan_tpu.eval import fid as j_fid
from shmgan_tpu.infer import make_infer_fn as j_make_infer_fn
from shmgan_tpu.ops.ssim import ssim as j_ssim
from shmgan_tpu.train import state as j_state
from shmgan_tpu.train.state import build_models as j_build_models
from shmgan_tpu_torch import quality_train as qt
from shmgan_tpu_torch.checkpoint import (CheckpointManager, export_inference_bundle,
                                         transfer_matching_params)
from shmgan_tpu_torch.convert import flax_tree, load_inference_weights
from shmgan_tpu_torch.data import synthetic_device as S
from shmgan_tpu_torch.data import synthetic_dr as DR
from shmgan_tpu_torch.data.codecs import decode
from shmgan_tpu_torch.data.synthetic import synth_eval_set
from shmgan_tpu_torch.eval import fid
from shmgan_tpu_torch.infer import make_infer_fn
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.utils.viz import image_grid, rescale_for_display

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, FILTER, BASE, B = 64, 8, 4, 2
U = jax.random.uniform
H = tsd.H


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def _jax_quality_train():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_train", os.path.join(REPO, "examples", "quality_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the GAN phase's DR views ----------------------------------------------------------

def j_scene_views_dr(key):
    """synth_scene_views_dr's draws: the DR scene's (its noise the camera's,
    from fold_in(k_noise, 1)), phi and pol_frac, the views' noise."""
    raw = tsd.j_scene_dr(key, True, False)
    k_noise = jax.random.split(key, 12)[10]
    k_phi, k_pol = jax.random.split(jax.random.fold_in(key, 7))
    raw = raw[:-1] + (jax.random.normal(jax.random.fold_in(k_noise, 1), (H, H, 3)),)
    return (raw, U(k_phi, (), minval=0.0, maxval=jnp.pi), U(k_pol, (), minval=0.6, maxval=0.95),
            jax.random.normal(k_noise, (4, H, H, 3)))


def scene_views_tree(raw):
    return DR.SceneViewsDRDraws(tsd.scene_dr_tree(raw[0]), t(raw[1]), t(raw[2]), t(raw[3]))


def j_views_batch_dr(key, batch, base_mix):
    n_base = int(batch * base_mix)
    k_base, k_dr, k_swap = jax.random.split(key, 3)
    k_u, k_slot = jax.random.split(k_swap)
    n_dr = batch - n_base
    return (tsd.j_views(k_base, n_base),
            jax.vmap(j_scene_views_dr)(jax.random.split(k_dr, n_dr)), U(k_u, (n_dr,)),
            jax.random.randint(k_slot, (n_dr,), 0, 4))


def views_batch_tree(raw):
    base = raw[0]
    return DR.ViewsBatchDRDraws(S.ViewsDraws(tsd.scene_tree(base[0]), t(base[1]), t(base[2])),
                                scene_views_tree(raw[1]), t(raw[2]), t(raw[3]))


VIEWS_CASES = [("min", 0.0), ("min", 1.0), ("diffuse", 0.0), ("diffuse", 1.0)]


@pytest.fixture(scope="module")
def jviews():
    """JAX's side of the DR-view tests, one program."""
    def fn():
        k_scene = jax.random.split(jax.random.PRNGKey(21), 3)
        k_batch = jax.random.PRNGKey(22)
        return {
            "scene": (jax.vmap(j_scene_views_dr)(k_scene),
                      jax.vmap(lambda k: JDR.synth_scene_views_dr(k, H, H))(k_scene)),
            "batch_draws": j_views_batch_dr(k_batch, 4, 0.5),
            "batch": {c: JDR.synth_views_batch_dr(k_batch, 4, H, H, ed_mode=c[0],
                                                  camera_swap_prob=c[1], base_mix=0.5)
                      for c in VIEWS_CASES}}
    return tsd.compiled(fn)


def test_synth_scene_views_dr_on_jax_draws(jviews):
    raw, ref = jviews["scene"]
    got = DR.synth_scene_views_dr(scene_views_tree(raw), H, H)
    for name, g, r in zip(("views", "diffuse", "mask", "camera"), got, ref):
        tsd.assert_image(g, r, label=name)
    assert got[2].sum() > 0


@pytest.mark.parametrize("ed_mode,swap", VIEWS_CASES)
def test_synth_views_batch_dr_on_jax_draws(jviews, ed_mode, swap):
    """Two base stacks, then two DR stacks; swap 1.0 puts the camera image
    in one view of every stack."""
    d = views_batch_tree(jviews["batch_draws"])
    got = DR.synth_views_batch_dr_render(d, H, H, ed_mode, swap)
    assert got.shape == (5, 4, H, H, 3)
    tsd.assert_image(got, jviews["batch"][ed_mode, swap], label=f"{ed_mode} {swap}")


# -- FID, features, inception score ---------------------------------------------------------

@pytest.mark.parametrize("n,d", [(48, 8), (6, 16)], ids=["N>D", "N<D"])
def test_frechet_distance_matches_jax(n, d):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (0.8 * rng.standard_normal((n + 2, d)) + 0.3).astype(np.float32)
    scale = float(np.trace(np.cov(a.T)) + np.trace(np.cov(b.T)))
    for x, y in ((a, b), (a, a), (b, a)):
        got = float(fid.frechet_distance(t(x), t(y)))
        ref = float(j_fid.frechet_distance(jnp.asarray(x), jnp.asarray(y)))
        assert got >= 0.0 and abs(got - ref) <= 1e-4 * scale, (got, ref, scale)
    sa = np.cov(a.T).astype(np.float32)
    np.testing.assert_allclose(fid._cov(t(a)).numpy(), np.asarray(j_fid._cov(jnp.asarray(a))),
                               atol=1e-5 * np.abs(sa).max())
    np.testing.assert_allclose(fid._sym_sqrtm(t(sa)).numpy(),
                               np.asarray(j_fid._sym_sqrtm(jnp.asarray(sa))),
                               atol=1e-4 * np.abs(sa).max())


def _draw(tree, seed, scale):
    """Seeded values for every leaf of a shape tree (BN variances positive,
    scales near 1)."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    out = {}
    for path, leaf in flat.items():
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                     1.0 + 0.1 * v if path[-1] == "scale" else scale * v)
    return flax.traverse_util.unflatten_dict(out)


def _jcfg(in_channels=1, image_size=SIZE, **train):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(
        jcfg.model, image_size=image_size, filter_size=FILTER, specseg_base_filters=BASE,
        specseg_in_channels=in_channels, compute_dtype="float32",
        use_pallas_instance_norm=False)
    jcfg.train = dataclasses.replace(jcfg.train, **train)
    return jcfg


def _weights(in_channels, seed):
    """Seeded G params and SpecSeg variables, as flax trees."""
    jcfg = _jcfg(in_channels)
    gen, _, specseg = j_build_models(jcfg)
    s = SIZE
    shapes = jax.eval_shape(lambda: (
        gen.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 10)), jnp.zeros((1, s, s, 1)))
        ["params"],
        specseg.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, in_channels)), train=False)))
    return _draw(shapes[0], seed, 0.1), _draw(shapes[1], seed + 1, 0.2)


def _cfg(*extra):
    """The port's phase-B configuration of this file's sizes."""
    return qt.build_cfg(qt.parse_args(_gan_argv("unused", *extra)))


def _port_models(in_channels, g_params, ss_vars):
    cfg = _cfg("--specseg_in_channels", str(in_channels))
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, ss_vars)
    return cfg, gen, specseg


def _images(n, seed):
    ins, gts, _ = synth_eval_set(n, SIZE, seed=seed)
    return ins, gts


@pytest.mark.parametrize("in_channels", [1, 2])
def test_specseg_features_match_jax(in_channels):
    g_params, ss_vars = _weights(in_channels, 30 + in_channels)
    _, _, specseg = _port_models(in_channels, g_params, ss_vars)
    ins, gts = _images(8, 31)
    got = fid.specseg_features(specseg, t(ins)).numpy()
    ref = np.asarray(j_fid.specseg_features(ss_vars, jnp.asarray(ins), base_filters=BASE))
    assert got.shape == ref.shape == (8, 16 * BASE)
    scale = np.abs(ref).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got, ref, atol=tsd.STD_RTOL * scale, rtol=0)
    got_fid = float(fid.fid_from_images(specseg, t(ins), t(gts)))
    ref_fid = float(j_fid.fid_from_images(ss_vars, jnp.asarray(ins), jnp.asarray(gts),
                                          base_filters=BASE))
    fa, fb = fid.specseg_features(specseg, t(ins)), fid.specseg_features(specseg, t(gts))
    assert abs(got_fid - ref_fid) <= fid_tolerance(fa, fb), (got_fid, ref_fid)


def fid_tolerance(fa, fb):
    """1e-4 of tr Sa + tr Sb, plus what float32 rounding puts in the null
    space when there are fewer samples than features: each of the D - N + 1
    null eigenvalues of sqrt(Sa) Sb sqrt(Sa) may read up to eps times the
    largest, lam_a lam_b, and 2 tr(middle) adds its square root twice."""
    sa, sb = fid._cov(fa.double()), fid._cov(fb.double())
    null = max(fa.shape[1] - min(fa.shape[0], fb.shape[0]) + 1, 0)
    lam = float(torch.linalg.eigvalsh(sa)[-1] * torch.linalg.eigvalsh(sb)[-1])
    eps = float(torch.finfo(torch.float32).eps)
    return 1e-4 * float(torch.trace(sa) + torch.trace(sb)) + 2 * null * (eps * lam) ** 0.5


def test_inception_score_matches_jax():
    rng = np.random.default_rng(40)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[0] = np.eye(10, dtype=np.float32)[3]   # a one-hot row: the eps inside the logs
    got = float(fid.inception_score(t(probs)))
    ref = float(j_fid.inception_score(jnp.asarray(probs)))
    assert got > 1.0 and abs(got - ref) <= 1e-6 * ref, (got, ref)


# -- warm starts ------------------------------------------------------------------

def _flat(tree):
    return flax.traverse_util.flatten_dict(tree, sep="/")


@pytest.mark.parametrize("net", ["g_params", "d_params"])
def test_transfer_matching_params_128_to_256_matches_jax(net):
    """The same leaves kept and the same counts as JAX's, from a 128-px tree
    to a 256-px one: all of G, all of D but its Dense head."""
    def jax_tree(size, seed):
        shapes = jax.eval_shape(
            lambda: j_state.create_train_state(_jcfg(image_size=size), jax.random.PRNGKey(0)))
        return _draw(getattr(shapes, net), seed, 0.1)

    dst, src = jax_tree(256, 50), jax_tree(128, 51)
    j_merged, j_kept, j_fresh = j_checkpoint.transfer_matching_params(dst, src)
    idx = 0 if net == "g_params" else 1
    port_dst = flax_tree(build_models(_cfg("--image_size", "256"), device="cpu", seed=1)[idx])[0]
    port_src = flax_tree(build_models(_cfg("--image_size", "128"), device="cpu", seed=2)[idx])[0]
    merged, kept, fresh = transfer_matching_params(port_dst, port_src)
    assert (kept, fresh) == (j_kept, j_fresh)
    assert fresh == (0 if net == "g_params" else 1)
    j_from_src = {k for k, v in _flat(j_merged).items() if v is _flat(src)[k]}
    from_src = {k for k, v in _flat(merged).items() if v is _flat(port_src)[k]}
    assert from_src == j_from_src and len(from_src) == kept
    assert sorted(_flat(merged)) == sorted(_flat(port_dst))


def _small_state(image_size, seed, g_ema=0.0):
    a = qt.parse_args(_gan_argv("unused", "--image_size", str(image_size), "--g_ema",
                                str(g_ema)))
    cfg = qt.build_cfg(a)
    return a, cfg, create_train_state(cfg, build_models(cfg, device="cpu", seed=seed))


def test_warm_start_from_checkpoint_and_bundle(tmp_path):
    """--init_from: G and D from a 32-px checkpoint, D's head fresh, fresh
    optimizers, the EMA from the merged G; --init_from_bundle: G from a
    bundle."""
    _, _, src = _small_state(32, 1)
    CheckpointManager(str(tmp_path / "ckpt")).save(src, step=7)
    a, cfg, state = _small_state(SIZE, 2, g_ema=0.999)
    fresh_head = flax_tree(state.disc)[0]["out_class"]["kernel"].copy()
    a.init_from, a.init_from_image_size = str(tmp_path / "ckpt"), 32
    qt._warm_start(a, cfg, state, None, "cpu")
    for name in ("gen", "disc"):
        got, want = _flat(flax_tree(getattr(state, name))[0]), _flat(
            flax_tree(getattr(src, name))[0])
        same = {k for k in want if got[k].shape == want[k].shape}
        assert all(np.array_equal(got[k], want[k]) for k in same), name
        assert set(got) - same == ({"out_class/kernel"} if name == "disc" else set())
    np.testing.assert_array_equal(flax_tree(state.disc)[0]["out_class"]["kernel"], fresh_head)
    assert state.g_opt.count == 0 and all(float(m.abs().sum()) == 0 for m in state.g_opt.mu)
    for k, p in state.gen.named_parameters():
        assert torch.equal(state.ema_g[k], p)

    bundle = str(tmp_path / "b.msgpack")
    export_inference_bundle(src.gen, src.specseg, qt.build_cfg(a), bundle, step=7)
    a2, cfg2, state2 = _small_state(SIZE, 3)
    a2.init_from_bundle = bundle
    qt._warm_start(a2, cfg2, state2, None, "cpu")
    for k, v in _flat(flax_tree(src.gen)[0]).items():
        np.testing.assert_array_equal(_flat(flax_tree(state2.gen)[0])[k], v)


# -- gate, galleries ----------------------------------------------------------------------

GATE_CASES = [  # (best, psnr, fid, min_fid): the cases of tests/test_quality_cli.py
    ({"psnr": -1.0}, 20.0, 40.0, float("inf")), ({"psnr": 30.0}, 29.5, 1.0, 2.0),
    ({"psnr": 33.1}, 33.2, 15.15, 2.17), ({"psnr": 33.1}, 33.2, 3.5, 2.17),
    ({"psnr": 33.1}, 33.7, 8.5, 3.07), ({"psnr": 33.1}, 33.7, 15.0, 3.07),
    ({"psnr": 20.0}, 22.0, 50.0, 40.0), ({"psnr": 20.0}, 22.0, 170.0, 40.0),
    ({"psnr": 33.6, "step": 2500}, 34.0, 20.0, 3.07),
    ({"psnr": 33.6, "step": 2500}, 34.0, 4.0, 3.07)]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_is_better_checkpoint_matches_jax(case):
    args = GATE_CASES[case]
    assert qt.is_better_checkpoint(*args) == _jax_quality_train().is_better_checkpoint(*args)


@pytest.mark.parametrize("max_segment,size", [(-1, 256), (-1, 128), (0, 256), (25, 128)])
def test_resolve_segment_matches_jax(max_segment, size):
    assert qt.resolve_segment(max_segment, size) == \
        _jax_quality_train().resolve_segment(max_segment, size)


LIVE_CASES = {
    "seeds": ([{"step": 2500, "gen_psnr": 33.6, "gen_fid": 3.07},
               {"step": 5000, "gen_psnr": 33.5, "gen_fid": 8.5}], {"psnr": 33.6, "step": 2500},
              5000),
    "drops_later_steps": ([{"step": 2500, "gen_fid": 3.0}, {"step": 5000, "gen_fid": 1.0},
                           {"step": 7500, "gen_psnr": 40.0, "gen_fid": 1.0}],
                          {"psnr": 40.0, "step": 7500}, 2500),
    "missing_file": (None, None, 100),
}


@pytest.mark.parametrize("case", list(LIVE_CASES))
def test_seed_gate_from_live_matches_jax(tmp_path, case):
    history, best, step = LIVE_CASES[case]
    live = tmp_path / "quality_live.json"
    if history is not None:
        live.write_text(json.dumps({"history": history, "best": best}))
    args = (str(live), step, [], {"psnr": -1.0}, float("inf"))
    got = qt.seed_gate_from_live(*args)
    assert got == _jax_quality_train().seed_gate_from_live(*args)
    if case == "seeds":
        assert got[1] == {"psnr": 33.6, "step": 2500} and got[2] == 3.07


def test_image_grid_rescales_panels():
    rng = np.random.default_rng(60)
    rgb, grey = rng.random((8, 6, 3), np.float32) * 3 - 1, rng.random((8, 6, 1), np.float32)
    grid = image_grid([rgb, grey[..., 0], grey])
    assert grid.dtype == np.uint8 and grid.shape == (8, 3 * 6 + 2 * 4, 3)
    np.testing.assert_array_equal(grid[:, :6], np.round(rescale_for_display(rgb) * 255))
    panel = grid[:, 10:16]
    assert (panel[..., 0] == panel[..., 2]).all() and panel.min() == 0 and panel.max() == 255
    np.testing.assert_array_equal(grid[:, 6:10], 255)
    assert (rescale_for_display(np.full((2, 2), 0.3)) == 0).all()


# -- the oracle --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_pair():
    """The port's oracle chunk and JAX's chain (make_infer_fn, ssim,
    specseg_features, frechet_distance) on the same converted 2-channel
    weights and the same two draws of 4 images."""
    g_params, ss_vars = _weights(2, 70)
    cfg, gen, specseg = _port_models(2, g_params, ss_vars)
    j_infer = j_make_infer_fn(_jcfg(2))

    @jax.jit
    def j_chunk(ins_c, gts_c):
        out = j_infer(g_params, ss_vars, ins_c)

        def m(x):
            mse = jnp.mean((x - gts_c) ** 2, axis=(1, 2, 3))
            return (-10.0 * jnp.log10(jnp.maximum(mse, 1e-12)), j_ssim(x, gts_c, max_val=1.0),
                    j_fid.specseg_features(ss_vars, x, base_filters=BASE))
        return (m(out["gen_rgb_calibrated"]), m(ins_c),
                j_fid.specseg_features(ss_vars, gts_c, base_filters=BASE))

    infer = make_infer_fn(cfg, outputs=("gen_rgb_calibrated", "mask"))
    out = {}
    for seed in qt.EVAL_DRAW_SEEDS[:2]:
        ins, gts = _images(4, seed)
        port = qt.oracle_chunk(infer, gen, specseg, t(ins), t(gts))
        ref = jax.tree_util.tree_map(np.asarray, j_chunk(jnp.asarray(ins), jnp.asarray(gts)))
        out[seed] = (port, ref)
    return out


def test_oracle_chunk_per_image_psnr_ssim_match_jax(oracle_pair):
    for port, ref in oracle_pair.values():
        for (p_psnr, p_ssim, p_feat), (r_psnr, r_ssim, r_feat) in zip(port[:2], ref[:2]):
            np.testing.assert_allclose(p_psnr.numpy(), r_psnr, atol=1e-3, rtol=0)
            np.testing.assert_allclose(p_ssim.numpy(), r_ssim, atol=1e-4, rtol=0)
            np.testing.assert_allclose(p_feat.numpy(), r_feat, atol=1e-3 * np.abs(r_feat).max())
        assert port[3].shape == (4, SIZE, SIZE, 3) and port[4].shape == (4, SIZE, SIZE, 1)


def test_oracle_per_draw_fid_matches_jax(oracle_pair):
    for port, ref in oracle_pair.values():
        gt_p, gt_r = port[2], ref[2]
        for (_, _, f_p), (_, _, f_r) in zip(port[:2], ref[:2]):
            got = float(fid.frechet_distance(f_p, gt_p))
            want = float(j_fid.frechet_distance(jnp.asarray(f_r), jnp.asarray(gt_r)))
            assert abs(got - want) <= fid_tolerance(f_p, gt_p), (got, want)


# -- the trainer end to end ---------------------------------------------------------------------

def _gan_argv(out, *extra):
    return ["--cpu", "--phase", "gan", "--image_size", str(SIZE), "--filter_size", str(FILTER),
            "--specseg_base_filters", str(BASE), "--batch", str(B), "--dtype", "float32",
            "--gan_steps", "4", "--chunk", "2", "--eval_every", "2", "--eval_n", "4",
            "--fid_draws", "2", "--out", str(out), *extra]


def _jax_stub_step(cfg):
    def step(state, views, key, epoch):
        z = jnp.sum(views) * 0.0
        return state.replace(step=state.step + 1), {
            "total_G": z + 1.0, "total_D": z, "G1_L1": z, "G1_SSIM_loss": z}
    return step


def _jax_stub_infer(cfg, **kw):
    def infer(g_params, ss_vars, rgb):
        return {"gen_rgb_calibrated": 0.9 * rgb + 0.05, "mask": rgb[..., :1]}
    return infer


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's trainer, --phase gan, 4 steps with evals at 2 and 4, on a stub
    step and inference: its summary and quality_live.json."""
    real = j_state.create_train_state

    def zeros_state(cfg, rng, specseg_vars=None):
        shapes = jax.eval_shape(lambda r: real(cfg, r), rng)
        state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return state.replace(specseg_vars=_draw(shapes.specseg_vars, 80, 0.2))

    out = tmp_path_factory.mktemp("jax_gan")
    from shmgan_tpu import infer as j_infer_mod
    from shmgan_tpu.train import step as j_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_state, "create_train_state", zeros_state)
        mp.setattr(j_step, "make_train_step", _jax_stub_step)
        mp.setattr(j_infer_mod, "make_infer_fn", _jax_stub_infer)
        summary = _jax_quality_train().main(_gan_argv(out)[1:])
    with open(out / "quality_live.json") as f:
        return summary, json.load(f)


def _keys(summary, live):
    gan = summary["gan"]
    return (sorted(summary), sorted(gan), [sorted(r) for r in gan["history"]],
            sorted(gan["best"]), sorted(live), sorted(live["config"]),
            [sorted(r) for r in live["history"]])


def test_phase_gan_on_the_cpu(tmp_path, jax_run):
    """Keys of the summary, its history rows and quality_live.json equal
    JAX's; galleries decode; best_bundle.msgpack reads through JAX's
    loader; the run's evals at steps 2 and 4."""
    summary = qt.main(_gan_argv(tmp_path, "--gan_curriculum", "dr", "--g_ema", "0.999"))
    with open(tmp_path / "quality_live.json") as f:
        live = json.load(f)
    with open(tmp_path / "quality_summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert _keys(summary, live) == _keys(*jax_run)
    gan = summary["gan"]
    assert [r["step"] for r in gan["history"]] == [2, 4] == [r["step"] for r in live["history"]]
    assert gan["train_steps"] == 4 and gan["final"] == gan["history"][-1]
    assert all(len(r["gen_fid_draws"]) == 2 and np.isfinite(r["gen_psnr"])
               for r in gan["history"])
    for tag in ("best", "final"):
        for i in range(4):
            img = decode((tmp_path / f"sample_{tag}_{i}.png").read_bytes())
            assert img.shape == (SIZE, 4 * SIZE + 3 * 4, 3)
    g_params, ss_vars, header = j_checkpoint.load_inference_bundle(
        str(tmp_path / "best_bundle.msgpack"))
    assert header["store_dtype"] == "float16" and header["step"] == gan["best"]["step"]
    assert header["image_size"] == SIZE and header["specseg_base_filters"] == BASE
    assert all(np.isfinite(v).all() for v in jax.tree_util.tree_leaves(g_params))


def test_phase_gan_resumes_at_the_saved_step(tmp_path):
    first = qt.main(_gan_argv(tmp_path))["gan"]
    again = qt.main(_gan_argv(tmp_path, "--gan_steps", "6"))["gan"]
    assert first["train_steps"] == 4 and again["train_steps"] == 6
    assert [r["step"] for r in again["history"]] == [2, 4, 6]
    assert again["history"][:2] == first["history"]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2, 4, 6]


def test_phase_gan_segments_end_in_the_same_state(tmp_path, capsys, monkeypatch):
    """--max_segment 0 (the whole chunk), 2 and auto at a 1 ms budget split
    one chunk of 6 steps three ways (6; 2+2+2; 5+1, each segment ended by a
    synchronisation) and end in the same checkpoint bit for bit; the auto
    run logs its plan and, with the chunk's line, the segmenter's summary."""
    seen = []

    class Spy(qt.AdaptiveSegmenter):
        def observe(self, length, wall_s):
            seen.append(length)
            super().observe(length, wall_s)

    monkeypatch.setattr(qt, "AdaptiveSegmenter", Spy)
    states = {}
    for seg in ("0", "2", "auto"):
        qt.main(_gan_argv(tmp_path / seg, "--gan_steps", "6", "--chunk", "100",
                          "--eval_every", "6", "--fid_draws", "1", "--max_segment", seg,
                          "--segment_budget_s", "0.001"))
        states[seg] = (tmp_path / seg / "ckpt" / "6" / "state.msgpack").read_bytes()
    log = capsys.readouterr().out
    assert states["0"] == states["2"] == states["auto"]
    assert seen == [5, 1]
    assert "[gan] chunk 100 run as segments of <= 2 steps" in log
    summary = "segment=100 (unmeasured, budget 0s)"   # min(chunk, 100), not yet moved
    assert f"[gan] adaptive segmenting: {summary}" in log
    assert any(line.endswith(f"img/s) | {summary}") and "[gan 6/6]" in line
               for line in log.splitlines())


def test_phase_gan_stops_at_a_segment_end_past_the_deadline(tmp_path, monkeypatch):
    """The deadline is read at every segment's end: when the ranks agree it
    has passed after the first of three 2-step segments, the chunk ends
    there, and the run evaluates and saves at step 2, not 6."""
    flags = []

    def agree_any(flag):
        flags.append(flag)
        return len(flags) > 1   # the deadline passes during the first segment

    monkeypatch.setattr(qt, "agree_any", agree_any)
    summary = qt.main(_gan_argv(tmp_path, "--gan_steps", "6", "--chunk", "6", "--eval_every",
                                "100", "--fid_draws", "1", "--max_segment", "2"))["gan"]
    assert summary["train_steps"] == 2 and summary["final"]["step"] == 2
    # read before the chunk, after its first segment, and again before the next chunk
    assert flags == [False, False, False]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]


def test_phase_both_on_the_cpu(tmp_path, jax_run):
    summary = qt.main(_gan_argv(tmp_path, "--phase", "both", "--specseg_batch", "2",
                                "--specseg_steps", "2", "--specseg_in_channels", "2",
                                "--gan_steps", "2"))
    assert sorted(summary) == ["args", "gan", "specseg"]
    assert sorted(summary["gan"]) == sorted(jax_run[0]["gan"])
    assert summary["specseg"]["in_channels"] == 2
    assert [r["step"] for r in summary["gan"]["history"]] == [2]
