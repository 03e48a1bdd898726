"""The port's eval metrics (eval/metrics.py), its Lab and colour-difference
ops (ops/color.py), psnr and mse (ops/ssim.py) and its model summaries
(utils/viz.py) against the JAX package's, on the CPU, on seeded pairs.

Tolerances (f32 on both sides, the same formulas in the same order; the
port's Lab cube root is x ** (1/3), within an ulp of jnp.cbrt):
  - Lab: atol 1e-4 on values up to 100 (a few ulps of 100);
  - Lab -> RGB and the white balance: atol 1e-5 on [0, 1];
  - per-pixel deltaE76 / deltaE94: atol 2e-4;
  - evaluate_pair, per image: ssim, psnr, mse and both deltaE means rtol 1e-5;
  - psnr rtol 1e-6, mse rtol 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.eval.metrics import MetricAccumulator as JMetricAccumulator
from shmgan_tpu.eval.metrics import evaluate_pair as j_evaluate_pair
from shmgan_tpu.ops import color as jcolor
from shmgan_tpu.ops.ssim import mse as j_mse
from shmgan_tpu.ops.ssim import psnr as j_psnr
from shmgan_tpu.train.state import create_train_state as j_create_train_state
from shmgan_tpu.utils.viz import model_summary as j_model_summary
from shmgan_tpu.utils.viz import write_model_summaries as j_write_model_summaries
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import flax_tree
from shmgan_tpu_torch.eval.metrics import MetricAccumulator, evaluate_pair
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.ops import color
from shmgan_tpu_torch.ops.ssim import mse, psnr
from shmgan_tpu_torch.utils.viz import model_summary, write_model_summaries


def _pair(seed, shape=(3, 24, 20, 3)):
    """A generated-like image and its target: correlated, both in [0, 1],
    with some values clipped at both ends."""
    rng = np.random.default_rng(seed)
    t = rng.random(shape, dtype=np.float32)
    g = np.clip(t + 0.15 * rng.standard_normal(shape).astype(np.float32), -0.05, 1.05)
    return g.astype(np.float32), t


def _j(fn, *arrays):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays)))


def _t(fn, *arrays):
    return fn(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy()


def test_lab_round_trip_matches_jax():
    g, _ = _pair(1)
    rgb = np.clip(g, 0, 1)
    lab = _t(color.rgb_to_lab, rgb)
    np.testing.assert_allclose(lab, _j(jcolor.rgb_to_lab, rgb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_t(color.lab_to_rgb, lab), _j(jcolor.lab_to_rgb, lab),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_t(color.lab_to_rgb, lab), rgb, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fn", ["delta_e_76", "delta_e_94"])
def test_delta_e_matches_jax(fn):
    g, t = _pair(2)
    lab_g, lab_t = (_j(jcolor.rgb_to_lab, np.clip(x, 0, 1)) for x in (g, t))
    np.testing.assert_allclose(_t(getattr(color, fn), lab_g, lab_t),
                               _j(getattr(jcolor, fn), lab_g, lab_t), rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (16, 12, 3)])
def test_gray_world_white_balance_matches_jax(shape):
    g, _ = _pair(3, shape)
    np.testing.assert_allclose(_t(color.gray_world_white_balance, g),
                               _j(jcolor.gray_world_white_balance, g), rtol=0, atol=1e-5)


def test_psnr_and_mse_match_jax():
    g, t = _pair(4)
    np.testing.assert_allclose(psnr(torch.from_numpy(g), torch.from_numpy(t), 1.0).numpy(),
                               np.asarray(j_psnr(jnp.asarray(g), jnp.asarray(t), 1.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mse(torch.from_numpy(g), torch.from_numpy(t))),
                               float(j_mse(jnp.asarray(g), jnp.asarray(t))), rtol=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_evaluate_pair_matches_jax(seed):
    g, t = _pair(seed, (4, 32, 32, 3))
    want = {k: np.asarray(v) for k, v in j_evaluate_pair(jnp.asarray(g), jnp.asarray(t)).items()}
    got = evaluate_pair(torch.from_numpy(g), t)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (4,) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, err_msg=k)


def test_metric_accumulator_rows_match_jax(tmp_path):
    g, t = _pair(7, (3, 32, 32, 3))
    jacc, acc = JMetricAccumulator(), MetricAccumulator()
    jacc.add(j_evaluate_pair(jnp.asarray(g), jnp.asarray(t)), wall_time=0.5)
    acc.add(evaluate_pair(torch.from_numpy(g), t), wall_time=0.5)
    jacc.dump_jsonl(str(tmp_path / "j.jsonl"))
    acc.dump_jsonl(str(tmp_path / "p.jsonl"))
    jrows = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    rows = [json.loads(x) for x in open(tmp_path / "p.jsonl")]
    assert len(rows) == len(jrows) == 4
    for row, jrow in zip(rows, jrows):
        assert list(row) == list(jrow)     # the keys, in JAX's order
        flat = row.get("mean", row)
        jflat = jrow.get("mean", jrow)
        for k in jflat:
            np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-5, err_msg=k)
    report = acc.report().splitlines()
    assert report[0].split("\t") == ["Image#", *MetricAccumulator.COLUMNS]
    assert len(report) == 5 and report[-1].startswith("MEAN\t")


def _small_configs():
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=32, filter_size=8,
                                     specseg_base_filters=4)
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=32, filter_size=8,
                                    specseg_base_filters=4)
    return jcfg, cfg


def test_model_summaries_match_jax(tmp_path):
    """The text of each summary equals JAX's for the same configuration."""
    jcfg, cfg = _small_configs()
    shapes = jax.eval_shape(lambda: j_create_train_state(jcfg, jax.random.PRNGKey(0)))
    gen, disc, specseg = build_models(cfg, device="cpu")
    ss_params, ss_stats = flax_tree(specseg)
    trees = (flax_tree(gen)[0], flax_tree(disc)[0],
             {"params": ss_params, "batch_stats": ss_stats})
    for tree, jtree, name in zip(trees, (shapes.g_params, shapes.d_params,
                                         shapes.specseg_vars), ("G", "D", "SpecSeg")):
        assert model_summary(tree, name) == j_model_summary(jtree, name)
    write_model_summaries(*trees, out_dir=str(tmp_path / "port"))
    j_write_model_summaries(shapes.g_params, shapes.d_params, shapes.specseg_vars,
                            out_dir=str(tmp_path / "jax"))
    for fname in ("Generator_summary.txt", "Discriminator_summary.txt", "SpecSeg_summary.txt"):
        assert (tmp_path / "port" / fname).read_text() == (tmp_path / "jax" / fname).read_text()
