"""make_infer_fn and the batch engine of the port against the JAX package's
on the CPU: every output, the cyclic pass and dihedral TTA, on weights
carried over by convert.py, and once on the committed trained 128-px bundle.

Both sides run with compute_dtype="float32" (tests/test_torch_bf16.py holds
the bfloat16 default). Tolerance:
abs 1e-3 on the [0, 1] outputs (mask, calibrated, composited) and 1e-3
relative to the output's scale on the others; the convolutions sum in
another order in the two frameworks.
"""

import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.checkpoint import load_inference_bundle
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.infer import fit_affine_luma as j_fit_affine_luma
from shmgan_tpu.infer import make_infer_fn as j_make_infer_fn
from shmgan_tpu.train.state import build_models as j_build_models
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import load_inference_weights
from shmgan_tpu_torch.infer import OUTPUTS, fit_affine_luma, make_infer_fn
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.serve import BatchInferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT_RANGE = ("mask", "gen_rgb_calibrated", "gen_rgb_composited")


def _configs(image_size=32, filter_size=8, base=4, in_channels=1,
             upsample_mode="conv_transpose", tta=False, prior=False):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(
        jcfg.model, image_size=image_size, filter_size=filter_size,
        specseg_base_filters=base, specseg_in_channels=in_channels,
        upsample_mode=upsample_mode, compute_dtype="float32")
    jcfg.eval = dataclasses.replace(jcfg.eval, mask_tta=tta, mask_chroma_prior=prior)
    cfg = Config()
    for k in ("filter_size", "specseg_in_channels", "upsample_mode", "compute_dtype"):
        setattr(cfg.model, k, getattr(jcfg.model, k))
    cfg.model.specseg_base_filters = base
    cfg.eval.mask_tta, cfg.eval.mask_chroma_prior = tta, prior
    return jcfg, cfg


def _random_weights(jcfg, seed):
    """Seeded weights for every leaf of G and SpecSeg (shapes from eval_shape)."""
    gen, _, specseg = j_build_models(jcfg)
    s, c = jcfg.model.image_size, jcfg.model.c_dim
    shapes = jax.eval_shape(lambda: (
        gen.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 2 * c)), jnp.zeros((1, s, s, 1)))
        ["params"],
        specseg.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, s, s, jcfg.model.specseg_in_channels)), train=False)))
    rng = np.random.default_rng(seed)

    def draw(tree, scale):
        flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
        out = {}
        for path, leaf in flat.items():
            v = rng.standard_normal(leaf.shape).astype(np.float32)
            out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                         1.0 + 0.1 * v if path[-1] == "scale" else scale * v)
        return flax.traverse_util.unflatten_dict(out)

    return draw(shapes[0], 0.1), draw(shapes[1], 0.2)


def _images(n, size, seed):
    """Smooth seeded scenes with a few bright, near-white highlights."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(n):
        base = rng.uniform(0.15, 0.6, 3)[None, None] * (0.6 + 0.4 * xx[..., None])
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.004)[..., None]
            base = base + (0.95 - base) * blob
        imgs.append(base + 0.02 * rng.standard_normal((size, size, 3)))
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


def _close(got, want, key):
    want = np.asarray(want)
    tol = 1e-3 if key in UNIT_RANGE else 1e-3 * max(1.0, np.abs(want).max())
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, atol=tol, err_msg=key)


def _port(cfg, g_params, specseg_vars):
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, specseg_vars)
    return gen, specseg


@pytest.mark.parametrize("variant", [
    dict(),
    dict(in_channels=2, upsample_mode="resize_conv", tta=True, prior=True),
], ids=["parity", "chroma-tta-resize"])
def test_all_outputs_match_jax(variant):
    jcfg, cfg = _configs(**variant)
    g_params, specseg_vars = _random_weights(jcfg, seed=11)
    rgb = _images(2, 32, seed=12)
    want = j_make_infer_fn(jcfg, with_cyclic=True)(g_params, specseg_vars, jnp.asarray(rgb))
    gen, specseg = _port(cfg, g_params, specseg_vars)
    got = make_infer_fn(cfg, with_cyclic=True)(gen, specseg, torch.from_numpy(rgb))
    assert set(got) == set(want) == set(OUTPUTS) | {"cyc_rgb"}
    for k in want:
        _close(got[k].numpy(), want[k], k)


def test_fit_affine_luma_matches_jax():
    rng = np.random.default_rng(13)
    gen_y = rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    y_ref = 0.7 * gen_y + 0.1 + 0.01 * rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    w = rng.random((3, 8, 8, 1)).astype(np.float32)
    w[1] = 0.0  # degenerate: identity fit
    a, b = fit_affine_luma(*(torch.from_numpy(v) for v in (gen_y, y_ref, w)))
    ja, jb = j_fit_affine_luma(jnp.asarray(gen_y), jnp.asarray(y_ref), jnp.asarray(w))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
    assert a[1].item() == 1.0 and b[1].item() == 0.0


def test_engine_pads_partial_batches():
    jcfg, cfg = _configs()
    g_params, specseg_vars = _random_weights(jcfg, seed=14)
    rgb = _images(5, 32, seed=15)
    gen, specseg = _port(cfg, g_params, specseg_vars)
    out = BatchInferenceEngine(cfg, gen, specseg, batch_size=4, with_cyclic=True,
                               device="cpu").process_images(rgb)
    want = j_make_infer_fn(jcfg, with_cyclic=True)(g_params, specseg_vars, jnp.asarray(rgb))
    assert out["cyc_rgb"].shape == (5, 5, 32, 32, 3)
    for k in want:
        _close(out[k], want[k], k)


def test_engine_rejects_bad_shapes():
    _, cfg = _configs()
    gen, _, specseg = build_models(cfg, device="cpu", seed=0)
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu")
    with pytest.raises(ValueError):
        engine.process_images(np.zeros((2, 32, 32, 4), np.float32))


def test_trained_bundle_matches_jax():
    """The committed 128-px bundle, carried over by convert.py, at B = 1."""
    g_params, specseg_vars, header = load_inference_bundle(
        os.path.join(REPO, "artifacts", "shmgan_infer.msgpack"))
    jcfg, cfg = _configs(image_size=header["image_size"], filter_size=header["filter_size"],
                         base=header["specseg_base_filters"],
                         in_channels=header["specseg_in_channels"],
                         upsample_mode=header["upsample_mode"], prior=True)
    rgb = _images(1, 128, seed=16)
    want = j_make_infer_fn(jcfg)(g_params, specseg_vars, jnp.asarray(rgb))
    gen, specseg = _port(cfg, g_params, specseg_vars)
    got = make_infer_fn(cfg)(gen, specseg, torch.from_numpy(rgb))
    for k in want:
        _close(got[k].numpy(), want[k], k)
    assert float(np.asarray(want["mask"]).max()) > 0.5  # the trained net finds highlights
