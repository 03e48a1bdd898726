"""The port's checkpoint evaluators (shmgan_tpu_torch/quality_eval.py,
ood_eval.py, mask_ab.py) against the JAX package's (examples/quality_eval.py,
ood_eval.py, mask_ab.py, loaded with importlib), both run with --cpu on the
same weights, at tests/test_torch_quality_gan.py's sizes (64 px, filter 8,
SpecSeg base 4, float32) and its seeded weights (scaled so that SpecSeg's
features are far from zero); 70 held-out images in chunks of 10, more
images than the 64 features.

  - ood_eval: parts A and B on a bundle of the port's
    export_inference_bundle, which JAX's load_inference_bundle reads;
  - quality_eval: a JAX Orbax checkpoint (seeded G, SpecSeg and EMA G, step
    7) converted by orbax_to_torch.py, with and without --use_ema; the port
    pointed at the Orbax directory raises with the converter's command;
  - mask_ab: 1- and 2-channel SpecSeg msgpacks of save_specseg_msgpack, with
    --tta --prior, an arm of two seeds and an ensemble.

Part B and mask_ab's photo columns read a synthetic 3 x 10 grid PNG
(test_torch_ood.write_grid), patched in as each side looks it up: the
module attribute `reference_photo_crops` of shmgan_tpu.data.ood (JAX's
scripts import it inside main) and of shmgan_tpu_torch.data.ood. JAX's
`create_train_state` is replaced by zero leaves of its `jax.eval_shape`
(the restore or the bundle fills what the scripts read; its eager init
takes most of a minute here), its `specseg_features` by the same function
jitted, its matplotlib galleries by empty files, and one jitted inference
serves every JAX run of the same graph.

Tolerances (each JSON value is rounded, PSNR, SSIM and evaluate_pair's
table to 4 decimals, FID to 5, the outside-mask PSNR to 2: one unit of
that rounding is added to each):
  - the outputs of every inference chunk: calibrated, composited and the
    mask's probabilities within 1e-3, make_infer_fn's parity
    (tests/test_torch_infer.py; read here: outputs 9e-6, masks 1.9e-4,
    so 1e-5 would not hold for the masks at these weights);
  - PSNR within 1e-3 dB, SSIM within 1e-4, evaluate_pair's table within
    1e-3 relative;
  - FID: the features of the same images (the identity block's inputs,
    the truth) within 1e-3 of their largest; the port's FID of JAX's
    features within `fid_tolerance` of JAX's FID (the rounding of the
    covariances' null space, here 37 of 64 eigenvalues); the two FIDs
    within 1e-2 relative of each other beyond that: the outputs of these
    random G are nearly flat (luma std ~0.006 against the inputs' 0.16),
    and the standardised luma SpecSeg embeds amplifies their 1e-6
    differences to ~4e-3 of the features;
  - figures of a mask thresholded at t (IoU, precision, recall, fractions,
    the luma drop inside it, the PSNR outside it): the thresholded masks
    may differ only at pixels within 1e-3 of t, and each figure by the
    share of k such pixels in its denominator n (2k / (n - k)) beyond its
    rounding; mask_ab fed JAX's probabilities writes JAX's file exactly.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shmgan_tpu.infer as j_infer_mod
import shmgan_tpu.train.state as j_state
import test_torch_quality_gan as tqg
from shmgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from shmgan_tpu.data import ood as j_ood
from shmgan_tpu.eval import fid as j_fid
from shmgan_tpu.utils import viz as j_viz
from shmgan_tpu_torch import mask_ab, ood_eval, quality_eval
from shmgan_tpu_torch.checkpoint import export_inference_bundle, save_specseg_msgpack
from shmgan_tpu_torch.data import ood
from shmgan_tpu_torch.eval import fid, quality
from test_torch_ood import write_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, FILTER, BASE = tqg.SIZE, tqg.FILTER, tqg.BASE
EVAL_N, EVAL_B = 70, 10
OUT_ATOL, MASK_ATOL, FEAT_RTOL, FID_RTOL = 1e-3, 1e-3, 1e-3, 1e-2
PSNR_ATOL, SSIM_ATOL, TABLE_RTOL = 1e-3, 1e-4, 1e-3
CKPT_STEP = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zeros_state(real):
    def create(cfg, rng, specseg_vars=None):
        shapes = jax.eval_shape(lambda r: real(cfg, r), rng)
        state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return state if specseg_vars is None else state.replace(specseg_vars=specseg_vars)
    return create


_JAX_INFER = {}


class Recorder:
    """Each side's inference outputs, in call order (JAX's by chunk, the
    port's by Evaluator.infer call), and the port's FID features."""

    def __init__(self, mp):
        self.jax, self.port, self.fid_feats, self.j_fid_feats = [], [], [], []
        real_j, real_infer, real_fid, real_j_fid = (
            j_infer_mod.make_infer_fn, quality.Evaluator.infer, quality.frechet_distance,
            j_fid.frechet_distance)

        def j_make(cfg, *a, **k):
            # one jitted function for every run of the same graph
            key = (repr(cfg.model), repr(cfg.eval), a, tuple(sorted(k.items())))
            fn = _JAX_INFER.setdefault(key, real_j(cfg, *a, **k))

            def infer(*args):
                out = fn(*args)
                self.jax.append({k: np.asarray(out[k]) for k in quality.OUTPUTS})
                return out
            return infer

        def port_infer(ev, rgb):
            out = real_infer(ev, rgb)
            self.port.append(out)
            return out

        def fid(fa, fb):
            self.fid_feats.append((fa, fb))
            return real_fid(fa, fb)

        def j_fid_spy(fa, fb):
            self.j_fid_feats.append((np.asarray(fa), np.asarray(fb)))
            return real_j_fid(fa, fb)

        mp.setattr(j_infer_mod, "make_infer_fn", j_make)
        mp.setattr(quality.Evaluator, "infer", port_infer)
        mp.setattr(quality, "frechet_distance", fid)
        mp.setattr(j_fid, "frechet_distance", j_fid_spy)

    def outputs(self):
        """(port, JAX): each output of every call, concatenated."""
        return tuple({k: np.concatenate([r[k] for r in rows]) for k in quality.OUTPUTS}
                     for rows in (self.port, self.jax))


def _stub_grid(images, titles=None, path=None):
    """JAX's matplotlib gallery as an empty file: its name is compared, not
    its pixels."""
    open(path, "wb").close()


_J_FEATURES = jax.jit(j_fid.specseg_features, static_argnames=("base_filters",))


def _patch_common(mp, grid):
    """The grid as the reference figure on both sides; JAX's train state as
    zero leaves, its SpecSeg features jitted (its scripts call them eagerly,
    op by op), its galleries stubbed."""
    mp.setattr(j_ood, "reference_photo_crops",
               functools.partial(j_ood.reference_photo_crops, path=grid))
    mp.setattr(ood, "reference_photo_crops",
               functools.partial(ood.reference_photo_crops, path=grid))
    mp.setattr(j_state, "create_train_state", _zeros_state(j_state.create_train_state))
    mp.setattr(j_fid, "specseg_features", _J_FEATURES)
    mp.setattr(j_viz, "image_grid", _stub_grid)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return write_grid(tmp_path_factory.mktemp("grid") / "results.png", seed=5)


def _check_outputs(got, want):
    for k in ("gen_rgb_calibrated", "gen_rgb_composited"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=OUT_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=MASK_ATOL, rtol=0)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if not isinstance(tree, (int, float)) else "number"


def fid_tolerance(fa, fb):
    """test_torch_quality_gan.fid_tolerance with the null space counted
    from the covariances' spectra: 1e-4 of tr Sa + tr Sb, and for each
    eigenvalue of Sa or Sb at or under D eps of its largest (dead or
    collapsed features, or fewer samples than features) what float32
    rounding may leave of it in sqrt(Sa) Sb sqrt(Sa), twice the square root
    of eps lam_a lam_b."""
    sa, sb = fid._cov(fa.double()), fid._cov(fb.double())
    eps = float(torch.finfo(torch.float32).eps)
    spectra = [torch.linalg.eigvalsh(s) for s in (sa, sb)]
    null = max(int((e <= fa.shape[1] * eps * e[-1]).sum()) for e in spectra)
    lam = float(spectra[0][-1] * spectra[1][-1])
    return 1e-4 * float(torch.trace(sa) + torch.trace(sb)) + 2 * null * (eps * lam) ** 0.5


def _check_fid(got, want, port_feats, jax_feats, what):
    """FID: the port's features against JAX's where both embed the same
    images (`same`: the identity block's inputs, and the truth), the port's
    FID of JAX's features against JAX's FID, and the two FIDs."""
    (pa, pb), (ja, jb) = port_feats, jax_feats
    assert ja.shape[0] > ja.shape[1], "FID needs more images than features here"
    same = [(pb, jb)] + ([(pa, ja)] if what == "identity_baseline" else [])
    for p, j in same:
        np.testing.assert_allclose(p.numpy(), j, atol=FEAT_RTOL * np.abs(j).max(), rtol=0,
                                   err_msg=what)
    assert got == round(float(fid.frechet_distance(pa, pb)), 5), what
    ja, jb = torch.tensor(ja), torch.tensor(jb)
    tol = fid_tolerance(ja, jb)
    assert abs(float(fid.frechet_distance(ja, jb)) - want) <= tol + 1e-5, what
    assert abs(got - want) <= FID_RTOL * want + tol, (what, got, want)


def _check_block(got, want, port_feats, jax_feats, what):
    """One metric block: PSNR, SSIM, FID and evaluate_pair's table."""
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_ATOL + 1e-4, (what, got, want)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_ATOL + 1e-4, (what, got, want)
    _check_fid(got["fid"], want["fid"], port_feats, jax_feats, what)
    assert sorted(got["reference_style"]) == sorted(want["reference_style"])
    for k, w in want["reference_style"].items():
        assert abs(got["reference_style"][k] - w) <= TABLE_RTOL * abs(w) + 1e-4, (what, k)
    assert got.get("beats_identity") == want.get("beats_identity"), what


def _check_table(got, want, rec):
    """The identity, calibrated and composited blocks (the FIDs' order)."""
    for i, key in enumerate(("identity_baseline", "gen_calibrated", "gen_composited")):
        _check_block(got[key], want[key], rec.fid_feats[i], rec.j_fid_feats[i], key)


def _flips(p_got, p_want, t):
    """Pixels whose thresholded masks differ, after checking that each lies
    within MASK_ATOL of the threshold."""
    differ = (p_got > t) != (p_want > t)
    assert np.all(np.abs(p_want[differ] - t) <= MASK_ATOL), "a pixel far from t flipped"
    return int(differ.sum())


def _share(k, n):
    return 2.0 * k / max(n - k, 1.0)


# -- ood_eval --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ood_runs(tmp_path_factory, grid):
    root = tmp_path_factory.mktemp("ood_eval")
    g_params, ss_vars = tqg._weights(2, 60)
    cfg, gen, specseg = tqg._port_models(2, g_params, ss_vars)
    bundle = str(root / "bundle.msgpack")
    export_inference_bundle(gen, specseg, cfg, bundle, step=11)
    argv = ["--cpu", "--bundle", bundle, "--eval_n", str(EVAL_N), "--batch", str(EVAL_B)]
    with pytest.MonkeyPatch.context() as mp:
        _patch_common(mp, grid)
        rec = Recorder(mp)
        want = _jax_script("ood_eval").main(argv + ["--out", str(root / "jax")])
        got = ood_eval.main(argv + ["--out", str(root / "port")])
    with open(root / "port" / "quality_ood.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return got, want, rec, root


def test_ood_eval_writes_jax_keys(ood_runs):
    got, want, _, root = ood_runs
    assert _keys(got) == _keys(want)
    assert got["checkpoint_step"] == want["checkpoint_step"] == 11
    assert got["image_size"] == want["image_size"] == SIZE
    assert got["reference_photos"]["n"] == want["reference_photos"]["n"] == 10
    assert got["reference_photos"]["note"] == want["reference_photos"]["note"]
    names = sorted(os.listdir(root / "port"))
    assert names == sorted(n for n in os.listdir(root / "jax"))
    assert len([n for n in names if n.startswith("ood_photo_grid_")]) == 10


def test_ood_eval_part_a_matches_jax(ood_runs):
    got, want, rec, _ = ood_runs
    port_out, jax_out = rec.outputs()
    _check_outputs(port_out, jax_out)
    a_got, a_want = got["synthetic_ood"], want["synthetic_ood"]
    assert (a_got["eval_n"], a_got["seed"]) == (a_want["eval_n"], a_want["seed"])
    _check_table(a_got, a_want, rec)


def test_ood_eval_part_b_matches_jax(ood_runs, grid):
    got, want, rec, _ = ood_runs
    port_out, jax_out = rec.outputs()
    p_got, p_want = port_out["mask"][EVAL_N:], jax_out["mask"][EVAL_N:]
    np.testing.assert_allclose(p_got, p_want, atol=MASK_ATOL, rtol=0)
    k = _flips(p_got, p_want, 0.5)
    b_got, b_want = got["reference_photos"], want["reference_photos"]
    crops = ood.reference_photo_crops(SIZE, path=grid)
    pred = p_want > 0.5
    ref = crops["ref_masks"] > 0.5
    denominators = {"mask_iou_vs_reference": (pred | ref).sum(),
                    "mask_precision_vs_reference": pred.sum(),
                    "mask_recall_vs_reference": ref.sum(),
                    "mask_predicted_fraction": pred.size, "mask_reference_fraction": pred.size}
    for key, n in denominators.items():
        assert abs(b_got[key] - b_want[key]) <= 1e-4 + _share(k, n), (key, b_got[key], b_want[key])
    inside = int(pred.sum())
    outside = pred.size - inside
    deviation = {name: float(np.abs(port_out[key][EVAL_N:] - jax_out[key][EVAL_N:]).max())
                 for name, key in (("calibrated", "gen_rgb_calibrated"),
                                   ("composited", "gen_rgb_composited"))}
    for name, w in b_want["per_output"].items():
        g = b_got["per_output"][name]
        d = deviation.get(name, 0.0)   # the reference's output is the crop itself
        # luma (weights summing to 1) moves by at most d; a flipped pixel's
        # luma difference lies in [-1, 1], its squared error in [0, 1] a channel
        assert abs(g["specular_luma_drop"] - w["specular_luma_drop"]) \
            <= 1e-4 + d + _share(k, inside), name
        mse = 10.0 ** (-w["outside_mask_psnr_vs_input"] / 10.0)
        dmse = (k + k * mse) / max(outside - k, 1) + 2 * d
        assert dmse < mse, name
        assert abs(g["outside_mask_psnr_vs_input"] - w["outside_mask_psnr_vs_input"]) \
            <= 1e-2 - 10 * np.log10(1 - dmse / mse), name


# -- quality_eval ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """A JAX Orbax checkpoint of seeded G, SpecSeg (2 channels) and EMA G at
    step CKPT_STEP (every other leaf zero), and its conversion."""
    root = tmp_path_factory.mktemp("quality_eval")
    src, dst = str(root / "orbax"), str(root / "torch")
    jcfg = tqg._jcfg(2)
    jcfg.train = dataclasses.replace(jcfg.train, checkpoint_save_dir=src)
    shapes = jax.eval_shape(lambda: j_state.create_train_state(jcfg, jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    g_params, ss_vars = tqg._weights(2, 70)
    ema = tqg._draw(shapes.g_params, 72, 0.1)
    state = zeros.replace(step=jnp.asarray(CKPT_STEP, shapes.step.dtype),
                          g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
                          specseg_vars=jax.tree_util.tree_map(jnp.asarray, ss_vars),
                          ema_g_params=jax.tree_util.tree_map(jnp.asarray, ema))
    ckpt = JCheckpointManager(src)
    ckpt.save(state)
    ckpt.close()
    orbax_to_torch = importlib.util.module_from_spec(importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "orbax_to_torch.py")))
    orbax_to_torch.__spec__.loader.exec_module(orbax_to_torch)
    assert orbax_to_torch.convert(jcfg, dst) == [CKPT_STEP]
    return root, src, dst


def _quality_argv(ckpt_dir, out, *extra):
    return ["--cpu", "--ckpt_dir", ckpt_dir, "--image_size", str(SIZE), "--filter_size",
            str(FILTER), "--specseg_base_filters", str(BASE), "--specseg_in_channels", "2",
            "--eval_n", str(EVAL_N),
            "--batch", str(EVAL_B), "--out", out, *extra]


@pytest.fixture(scope="module")
def quality_runs(orbax_ckpt, grid):
    root, src, dst = orbax_ckpt
    runs = {}
    jax_script = _jax_script("quality_eval")
    for case, extra in (("raw", []), ("ema", ["--use_ema"])):
        with pytest.MonkeyPatch.context() as mp:
            _patch_common(mp, grid)
            rec = Recorder(mp)
            want = jax_script.main(_quality_argv(src, str(root / f"jax_{case}"), *extra))
            got = quality_eval.main(_quality_argv(dst, str(root / f"port_{case}"), *extra))
        runs[case] = (got, want, rec)
    return runs


@pytest.mark.parametrize("case", ["raw", "ema"])
def test_quality_eval_matches_jax(quality_runs, orbax_ckpt, case):
    got, want, rec = quality_runs[case]
    assert _keys(got) == _keys(want)
    assert (got["checkpoint_step"], got["eval_n"], got["heldout_seed"]) \
        == (want["checkpoint_step"], want["eval_n"], want["heldout_seed"]) \
        == (CKPT_STEP, EVAL_N, 999)
    port_out, jax_out = rec.outputs()
    _check_outputs(port_out, jax_out)
    _check_table(got, want, rec)
    out = orbax_ckpt[0] / f"port_{case}"
    assert sorted(os.listdir(out)) == sorted(os.listdir(orbax_ckpt[0] / f"jax_{case}"))
    with open(out / "quality_final.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))


def test_quality_eval_ema_is_the_ema_generator(quality_runs):
    """The EMA run evaluates another G than the raw run, on both sides."""
    raw, ema = quality_runs["raw"][2].outputs()[0], quality_runs["ema"][2].outputs()[0]
    assert np.abs(raw["gen_rgb_calibrated"] - ema["gen_rgb_calibrated"]).max() > 1e-2
    np.testing.assert_array_equal(raw["mask"], ema["mask"])


def test_quality_eval_refuses_an_orbax_directory(orbax_ckpt, tmp_path):
    _, src, _ = orbax_ckpt
    with pytest.raises(NotImplementedError, match="orbax_to_torch.py"):
        quality_eval.main(_quality_argv(src, str(tmp_path)))


# -- mask_ab ---------------------------------------------------------------------------

def _spy(real, record):
    def make(cfg, **kw):
        fn = real(cfg, **kw)

        def mask_fn(*args):
            out = fn(*args)
            record.append(np.asarray(out))
            return out
        return mask_fn
    return make


def _replay(record):
    """make_mask_fn whose functions return `record`'s probabilities in turn."""
    it = iter(record)
    return lambda cfg, **kw: (lambda net, rgb: torch.from_numpy(np.array(next(it))))


@pytest.fixture(scope="module")
def mask_ab_runs(tmp_path_factory, grid):
    """JAX's run and the port's, each mask call's probabilities recorded,
    and the port's run on JAX's probabilities."""
    root = tmp_path_factory.mktemp("mask_ab")
    paths = {}
    for name, in_ch, seed in (("one", 1, 80), ("s1", 2, 82), ("s2", 2, 84)):
        paths[name] = str(root / f"{name}.msgpack")
        save_specseg_msgpack(tqg._weights(in_ch, seed)[1], paths[name])
    argv = ["--cpu", "--nets", f"one={paths['one']}", "--arms",
            f"chroma={paths['s1']},{paths['s2']}", "--ensembles", "both=one+chroma#0",
            "--tta", "--prior", "--ood_n", "10", "--image_size", str(SIZE),
            "--specseg_base_filters", str(BASE)]
    probs = {"jax": [], "port": []}
    files = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_common(mp, grid)
        with mp.context() as m2:
            m2.setattr(j_infer_mod, "make_mask_fn", _spy(j_infer_mod.make_mask_fn, probs["jax"]))
            m2.setattr(mask_ab, "make_mask_fn", _spy(mask_ab.make_mask_fn, probs["port"]))
            _jax_script("mask_ab").main(argv + ["--out", str(root / "jax.json")])
            mask_ab.main(argv + ["--out", str(root / "port.json")])
        mp.setattr(mask_ab, "make_mask_fn", _replay(probs["jax"]))
        mask_ab.main(argv + ["--out", str(root / "replay.json")])
    for name in ("jax", "port", "replay"):
        with open(root / f"{name}.json") as f:
            files[name] = json.load(f)
    return files, probs


def test_mask_ab_probabilities_match_jax(mask_ab_runs):
    """3 nets x 4 variants x (OOD set, photos), in JAX's call order."""
    _, probs = mask_ab_runs
    assert len(probs["port"]) == len(probs["jax"]) == 3 * 4 * 2
    for p, j in zip(probs["port"], probs["jax"]):
        assert p.shape == j.shape and p.shape[1:] == (SIZE, SIZE, 1)
        np.testing.assert_allclose(p, j, atol=MASK_ATOL, rtol=0)


def test_mask_ab_figures_equal_jax_on_its_probabilities(mask_ab_runs):
    """Fed JAX's probabilities, the port writes JAX's file exactly: the
    rows, thresholds, dilations, arms (mean, sd, seeds) and ensembles."""
    files, _ = mask_ab_runs
    assert files["replay"] == files["jax"]
    assert list(files["jax"]["nets"]) == [
        f"{n}{v}" for n in ("one", "chroma#0", "chroma#1", "both")
        for v in ("", "+tta", "+prior", "+tta+prior")]
    assert list(files["jax"]["arms"]) == ["chroma", "chroma+tta", "chroma+prior",
                                          "chroma+tta+prior"]


def _iou_pr_tol(p, j, ref, t):
    """Each iou_pr figure's tolerance: its rounding, and the share of the
    pixels of p > t that differ from j > t in the figure's denominator
    (union, predicted, reference, all)."""
    k = _flips(p, j, t)
    pred, rb = j > t, ref > 0.5
    return {"iou": 1e-4 + _share(k, (pred | rb).sum()),
            "precision": 1e-4 + _share(k, pred.sum()),
            "recall": 1e-4 + _share(k, rb.sum()),
            "pred_fraction": 1e-4 + _share(k, pred.size)}


def _row_tol(got_row, want_row, ood_pair, photo_pair, ood_mask, ref_masks):
    """A tolerance for every figure of a mask_ab row, in its layout."""
    t_sel = want_row["ood_selected_threshold"]
    assert got_row["ood_selected_threshold"] == t_sel
    thresholds = [float(t) for t in mask_ab.THRESH_GRID]
    tol = {"synthetic_ood_vs_gt": _iou_pr_tol(*ood_pair, ood_mask, 0.5),
           "ood_iou_by_threshold": {str(t): _iou_pr_tol(*ood_pair, ood_mask, t)["iou"]
                                    for t in thresholds}}
    tol["real_photos_vs_reference_masks"] = _iou_pr_tol(*photo_pair, ref_masks, 0.5)
    tol["real_photos_at_ood_threshold"] = _iou_pr_tol(*photo_pair, ref_masks, t_sel)
    tol["photo_iou_by_threshold"] = {str(t): _iou_pr_tol(*photo_pair, ref_masks, t)["iou"]
                                     for t in thresholds}
    # a flipped pixel flips its whole (2r + 1)^2 neighbourhood in the dilation
    k = _flips(*photo_pair, 0.5)
    union = ((photo_pair[1] > 0.5) | (ref_masks > 0.5)).sum()
    tol["photo_iou_by_dilation"] = {str(r): 1e-4 + _share(k * (2 * r + 1) ** 2, union)
                                    for r in (1, 2, 3)}
    return tol


def _within(got, want, tol, path=""):
    """got against want, floats within tol (a tree of the same layout, or
    one number for a subtree), anything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _within(got[key], want[key], tol.get(key, 0.0) if isinstance(tol, dict) else tol,
                    f"{path}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _within(g, w, tol, f"{path}/{i}")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (path, got, want, tol)
    else:
        assert got == want, (path, got, want)


def test_mask_ab_matches_jax(mask_ab_runs, grid):
    """The port's own run: JAX's keys, and each figure within its rounding
    and the share of the pixels that flip (only within MASK_ATOL of the
    threshold) in its denominator; an arm's mean and seeds within the
    seed rows' tolerance, its sd (ddof 1, two seeds) within sqrt(2) of it."""
    files, probs = mask_ab_runs
    got, want = files["port"], files["jax"]
    assert _keys(got) == _keys(want)
    ood_mask = j_ood.synth_ood_set(10, SIZE, seed=mask_ab.OOD_SEED)[2]
    ref_masks = ood.reference_photo_crops(SIZE, path=grid)["ref_masks"]
    pairs = {}
    calls = iter(zip(probs["port"], probs["jax"]))
    for name in list(want["nets"])[:12]:   # the nets' rows, an OOD and a photo call each
        pairs[name] = (next(calls), next(calls))
    for variant in ("", "+tta", "+prior", "+tta+prior"):
        members = [pairs[m + variant] for m in ("one", "chroma#0")]
        pairs["both" + variant] = tuple(
            tuple(np.mean([m[i][side] for m in members], axis=0) for side in (0, 1))
            for i in (0, 1))
    tols = {}
    for name, row in want["nets"].items():
        tols[name] = _row_tol(got["nets"][name], row, *pairs[name], ood_mask, ref_masks)
        _within(got["nets"][name], row, tols[name], name)
    for name, agg in want["arms"].items():
        variant = name[len("chroma"):]
        seeds = [tols[f"chroma#{i}{variant}"] for i in (0, 1)]
        for section, figures in agg.items():
            if not isinstance(figures, dict):
                assert got["arms"][name][section] == figures, (name, section)
                continue
            for metric, stat in figures.items():
                t = max(s[section][metric] for s in seeds)
                _within(got["arms"][name][section][metric], stat,
                        {"mean": t, "sd": 2 ** 0.5 * t + 1e-4, "seeds": t}, f"{name}/{section}")
    assert got["image_size"] == want["image_size"]
    assert got["ref_mask_fraction"] == want["ref_mask_fraction"]
