"""The port's triplet adapter (data/triplets.py), its fixture writers
(data/synthetic.py) and the last small ops against the JAX package's, on
the CPU.

  - `TripletDataset` in both layouts, with mask files, with residue masks
    (no mask/ folder, an empty one, SHIQ without _S files), and
    `iter_epoch`'s shuffle and process split: every batch equal to
    shmgan_tpu.data.triplets' bit for bit (the same pixels, the same
    float32 arithmetic);
  - `write_triplet_fixture_tree` and `synth_polar_batch`: pixels and arrays
    equal to JAX's (the PNG bytes may differ: zlib settings);
  - `specseg_pairs`: Y within 1e-6 of JAX's before the standardisation;
    after it, within 1e-6 plus twice JAX's own distance from the float64
    result, and no farther from that result than JAX (the standardisation's
    E[x^2] - E[x]^2 cancels: at 24 px JAX's f32 Y is ~6e-5 from float64's,
    the port's ~2e-5); `triplet_to_views` exactly;
  - one SpecSeg train step on the port's triplet pairs (32 px, base 4, batch
    4, as test_triplets.py's) against JAX's step on the same pairs from the
    same weights and dropout masks, by the tolerances of
    test_torch_specseg_train.py: metrics within 1e-5 relative, batch
    statistics and Adam moments within 1e-4 of their leaf's scale,
    parameters within 6 lr. (The same pairs: SpecSeg at its init is nearly
    saturated on these scenes, and the pairs' 6e-5 f32 gap above moves its
    tiny gradients by a few per cent.);
  - `estimate_diffuse`, `calc_dop` (S0 = 0 included), `ssim_log_loss` and
    `rescale_01` (a constant tensor included) within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shmgan_tpu.data import synthetic as j_synthetic
from shmgan_tpu.data import triplets as j_triplets
from shmgan_tpu.ops import polar as j_polar
from shmgan_tpu.ops.color import rgb_to_yuv as j_rgb_to_yuv
from shmgan_tpu.ops.ssim import ssim_log_loss as j_ssim_log_loss
from shmgan_tpu.ops import standardize as j_standardize
from shmgan_tpu.train import specseg_train as j_specseg_train
from shmgan_tpu_torch.data import synthetic, triplets
from shmgan_tpu_torch.ops import polar, ssim, standardize
from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.train.specseg_train import (create_specseg_state, make_specseg_train_step,
                                                  specseg_vars_from_state)
from shmgan_tpu_torch.convert import to_flax
from test_torch_specseg_train import _KEEPS, LR, _cfg, _leaves, injected_dropout


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("layout,with_mask", [("folder", True), ("folder", False),
                                              ("shiq", True), ("shiq", False)])
def test_triplet_fixture_tree_pixels_are_jaxs(tmp_path, layout, with_mask):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    synthetic.write_triplet_fixture_tree(mine, 3, 24, seed=2, layout=layout,
                                         with_mask=with_mask)
    j_synthetic.write_triplet_fixture_tree(theirs, 3, 24, seed=2, layout=layout,
                                           with_mask=with_mask)
    assert _tree_files(mine) == _tree_files(theirs)
    for rel in _tree_files(mine):
        np.testing.assert_array_equal(_pixels(os.path.join(mine, rel)),
                                      _pixels(os.path.join(theirs, rel)), err_msg=rel)


@pytest.mark.parametrize("include_ed", [True, False])
def test_synth_polar_batch_is_jaxs(include_ed):
    got = synthetic.synth_polar_batch(3, 20, seed=4, include_ed=include_ed)
    want = j_synthetic.synth_polar_batch(3, 20, seed=4, include_ed=include_ed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _tree(tmp_path, case):
    """A triplet tree for `case`, written by the JAX package's writer."""
    root = str(tmp_path / case)
    layout = "shiq" if case.startswith("shiq") else "folder"
    with_mask = case in ("folder", "shiq", "shiq partial")
    j_synthetic.write_triplet_fixture_tree(root, 6, 24, seed=3, layout=layout,
                                           with_mask=with_mask)
    if case == "folder empty mask":
        os.makedirs(os.path.join(root, "mask"))
    if case == "shiq partial":          # a stem without _T, one _S missing
        os.remove(os.path.join(root, "img00002_T.png"))
        os.remove(os.path.join(root, "img00004_S.png"))
    return root


@pytest.mark.parametrize("case", ["folder", "folder no mask", "folder empty mask", "shiq",
                                  "shiq no mask", "shiq partial"])
def test_triplet_dataset_batches_are_jaxs(tmp_path, case):
    root = _tree(tmp_path, case)
    for cache in (True, False):
        mine = triplets.TripletDataset(root, 24, batch_size=2, cache_in_memory=cache)
        theirs = j_triplets.TripletDataset(root, 24, batch_size=2, cache_in_memory=cache)
        assert len(mine) == len(theirs) and mine.batches_per_epoch == theirs.batches_per_epoch
        for seed in (None, 7):
            for a, b in zip(mine.iter_epoch(seed), theirs.iter_epoch(seed)):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.float32
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case} {k}")
    if case == "folder":
        assert mine._load(np.arange(6))["mask"].sum() > 0


def test_iter_epoch_process_split_is_jaxs(tmp_path):
    root = _tree(tmp_path, "folder")
    mine = triplets.TripletDataset(root, 24, batch_size=4)
    theirs = j_triplets.TripletDataset(root, 24, batch_size=4)
    for p in range(2):
        for a, b in zip(mine.iter_epoch(3, p, 2), theirs.iter_epoch(3, p, 2)):
            assert a["image"].shape == (2, 24, 24, 3)
            np.testing.assert_array_equal(a["image"], b["image"])
    with pytest.raises(ValueError, match="not divisible"):
        next(mine.iter_epoch(None, 0, 3))
    with pytest.raises(FileNotFoundError):
        triplets.TripletDataset(str(tmp_path / "nothing"), 24)


def test_specseg_pairs_and_views_are_jaxs(tmp_path):
    batch = next(triplets.TripletDataset(_tree(tmp_path, "folder"), 24, 4).iter_epoch())
    y, m = triplets.specseg_pairs(batch, "cpu")
    jy, jm = j_triplets.specseg_pairs(batch)
    assert y.shape == (4, 24, 24, 1) and y.dtype == torch.float32 and y.device.type == "cpu"
    img = batch["image"]
    y_raw = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    np.testing.assert_allclose(rgb_to_yuv(torch.from_numpy(img)).numpy()[..., 0],
                               np.asarray(j_rgb_to_yuv(jnp.asarray(img)))[..., 0],
                               atol=1e-6, rtol=0)
    y64 = y_raw.astype(np.float64)
    mean = y64.mean((1, 2))
    ref = y64 / np.sqrt((y64 ** 2).mean((1, 2)) - mean ** 2)[:, None, None]
    jax_err = np.abs(np.asarray(jy)[..., 0] - ref).max()
    assert np.abs(y.numpy()[..., 0] - ref).max() <= jax_err + 1e-6
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6 + 2 * jax_err, rtol=0)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    views = triplets.triplet_to_views(batch)
    np.testing.assert_array_equal(views, j_triplets.triplet_to_views(batch))
    assert views.shape == (5, 4, 24, 24, 3)


def test_specseg_step_on_triplet_pairs_matches_jax(tmp_path):
    root = str(tmp_path / "t32")
    synthetic.write_triplet_fixture_tree(root, 4, 32, seed=5, layout="folder")
    batch = next(triplets.TripletDataset(root, 32, batch_size=4).iter_epoch())
    y, m = triplets.specseg_pairs(batch, "cpu")

    cfg, jcfg = _cfg()
    state = create_specseg_state(cfg, torch.Generator().manual_seed(5), "cpu")
    init = specseg_vars_from_state(state)
    keep = [k for k in state.net.sample_keep(torch.Generator().manual_seed(6), 4, 32, 32)]
    jstate = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda r: j_specseg_train.create_specseg_state(jcfg, r),
                       jax.random.PRNGKey(0)))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]))
    step = j_specseg_train.make_specseg_train_step(jcfg)

    @jax.jit
    def jstep(st, img, msk, keeps):
        _KEEPS[:] = list(keeps)
        return step(st, img, msk, jax.random.PRNGKey(0))

    with injected_dropout():
        jstate, jmetrics = jstep(jstate, jnp.asarray(y.numpy()), jnp.asarray(m.numpy()),
                                 [jnp.asarray(k.numpy().transpose(0, 2, 3, 1)) for k in keep])
    state, metrics = make_specseg_train_step(cfg)(state, y, m, keep)
    for k in ("dice", "focal", "loss", "iou"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5, abs=1e-7), k
    got = specseg_vars_from_state(state)
    for k, ref in _leaves(jstate.params).items():
        assert np.abs(_leaves(got["params"])[k] - ref).max() <= 6 * LR, k
    for k, ref in _leaves(jstate.batch_stats).items():
        np.testing.assert_allclose(_leaves(got["batch_stats"])[k], ref,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    mu, nu = state.opt.moments()
    adam = jstate.opt_state[1]
    for tree, ref in ((mu, adam.mu), (nu, adam.nu)):
        got_m = _leaves(to_flax(state.net, init["params"], tree))
        for k, r in _leaves(ref).items():
            np.testing.assert_allclose(got_m[k], r, atol=1e-4 * np.abs(r).max(), err_msg=k)
    assert state.step == int(jstate.step) == 1


def _views(seed, zero_s0=False):
    rng = np.random.default_rng(seed)
    v = rng.random((4, 2, 9, 11, 1)).astype(np.float32)
    if zero_s0:                          # S0 = I0 + I90 = 0 on a patch
        v[0, :, :3, :4] = 0.0
        v[2, :, :3, :4] = 0.0
    return v


def test_estimate_diffuse_is_jaxs():
    v = np.random.default_rng(8).random((4, 2, 9, 11, 3)).astype(np.float32)
    got = polar.estimate_diffuse(*map(torch.from_numpy, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_polar.estimate_diffuse(*v)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("zero_s0", [False, True])
def test_calc_dop_is_jaxs(zero_s0):
    v = _views(9, zero_s0)
    dop, aop = polar.calc_dop(*map(torch.from_numpy, v))
    jdop, jaop = j_polar.calc_dop(*map(jnp.asarray, v))
    np.testing.assert_allclose(dop.numpy(), np.asarray(jdop), atol=1e-6, rtol=0)
    np.testing.assert_allclose(aop.numpy(), np.asarray(jaop), atol=1e-6, rtol=0)
    if zero_s0:
        assert (dop.numpy()[:, :3, :4] == 0).all() and np.isfinite(dop.numpy()).all()


def test_ssim_log_loss_is_jaxs():
    s = np.linspace(-0.999, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(ssim.ssim_log_loss(torch.from_numpy(s)).numpy(),
                               np.asarray(j_ssim_log_loss(jnp.asarray(s))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("constant", [False, True])
def test_rescale_01_is_jaxs(constant):
    x = np.random.default_rng(10).normal(0, 3, (2, 7, 5, 3)).astype(np.float32)
    if constant:
        x[:] = 1.25
    got = standardize.rescale_01(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_standardize.rescale_01(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    if constant:
        assert (got == 0).all()
