"""chip_smoke.py's bf16 gap rule (_step_gap_stats, gap_readings,
_compare_gap_stats) on synthetic train-step metrics, on the CPU: each
batch's f32 gradients and losses, the plain bf16 path's (f32 plus bf16's
error: a shrink of deep leaves and noise) and the kernels' (the plain
path's plus noise drawn anew each batch, or a planted fault). No card, no
model: the rule's arithmetic against what it must tell apart."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

LEAVES = {"G": {"down0.w": (64, 27), "down1.w": (128, 64), "head.w": (3, 64), "head.b": (3,)},
          "D": {"c0.w": (32, 3, 4, 4), "c1.w": (64, 32, 4, 4), "cls.w": (5, 64), "cls.b": (5,)}}
LOSSES = ("D_cls", "D_rf", "G_gan", "L1", "style", "total_G")


def _batch(rng, kp_noise=0.75, fault=None, near_zero_loss=False):
    """One batch's (kernels, plain, f32) metrics. bf16's error (plain - f32):
    every leaf shrunk by 0.5 % plus noise of 1 % of its size; the honest
    kernels: the plain path plus noise of kp_noise times that noise, drawn
    anew. `fault` (net, scale) scales the kernels' gradients of one
    network; the losses: chaotic ones (noise alike on both paths, of
    1e-3 relative) and smooth ones (bf16 biases them by 3e-5, the kernels
    move them by 1e-6)."""
    f, p, k = {"_grads": {}}, {"_grads": {}}, {"_grads": {}}
    for net, leaves in LEAVES.items():
        for m in (f, p, k):
            m["_grads"][net] = {}
        for name, shape in leaves.items():
            g = rng.normal(0, 1, shape)
            e = -0.005 * g + 0.01 * rng.normal(0, 1, shape)
            d = kp_noise * 0.01 * rng.normal(0, 1, shape)
            kk = g + e + d
            if fault and fault[0] == net:
                kk = kk + (fault[1] - 1) * (g + e)
            for m, v in ((f, g), (p, g + e), (k, kk)):
                m["_grads"][net][name] = torch.tensor(v, dtype=torch.float32)
    for i, name in enumerate(LOSSES):
        value = float(rng.uniform(1, 10))
        if i < 3:                                   # chaotic: noise alike on both paths
            e, d = (rng.normal(0, 1e-3 * value) for _ in range(2))
            d *= kp_noise
        else:                                       # smooth: a bf16 bias, tiny kernel noise
            e, d = -3e-5 * value, rng.normal(0, 1e-6 * value)
        if near_zero_loss and name == "style":
            # a value near 0 whose noise is of the others' absolute size, the
            # kernels' 1.5 times bf16's
            value, e, d = 1e-9, rng.normal(0, 1e-3), 1.5 * rng.normal(0, 1e-3)
        if fault and fault[0] == "losses":
            d += (fault[1] - 1) * value
        for m, v in ((f, value), (p, value + e), (k, value + e + d)):
            m[name] = torch.tensor(v, dtype=torch.float64)
    return k, p, f


def _readings(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return cs.gap_readings([cs._step_gap_stats(*_batch(rng, **kw)) for _ in range(n)])


def test_stats_hold_each_leaf_and_loss():
    k, p, f = _batch(np.random.default_rng(1))
    st = cs._step_gap_stats(k, p, f)
    assert st["G"].shape == (4, 5) and st["D"].shape == (4, 5)
    assert st["loss_keys"] == sorted(LOSSES) and st["losses"].shape == (6, 3)
    g = {n: f["_grads"]["G"][n].double() for n in sorted(LEAVES["G"])}
    d0 = k["_grads"]["G"]["down0.w"].double() - p["_grads"]["G"]["down0.w"].double()
    i = sorted(LEAVES["G"]).index("down0.w")
    assert np.isclose(st["G"][i, 0], float((d0 * d0).sum()))
    assert np.isclose(st["G"][i, 3], float((d0 * g["down0.w"]).sum()))


@pytest.mark.parametrize("seed", range(4))
def test_honest_noise_passes_at_the_chosen_pooling(seed):
    """The two bf16 paths apart by 0.75 of bf16's own noise, drawn anew each
    batch: every reading under the limit at STEP_GAP_BATCHES batches, the
    L2 ones near 0.75, the scale one far under (noise is not aligned with
    the gradient)."""
    got = _readings(cs.STEP_GAP_BATCHES, seed=seed)
    assert set(got) == {"G gradients", "D gradients", cs.D_SCALE, cs.LOSSES}
    assert all(v <= cs.GAP_C for v in got.values()), got
    assert 0.55 < got["G gradients"] < 0.8 and got[cs.D_SCALE] < 0.4
    rng = np.random.default_rng(seed)
    cs._compare_gap_stats([cs._step_gap_stats(*_batch(rng)) for _ in range(cs.STEP_GAP_BATCHES)],
                          "honest:")


@pytest.mark.parametrize("net", ["G", "D"])
def test_a_systematic_one_percent_scaling_of_one_network_fails(net):
    """Kernels whose gradients of one network are 1 % too large on every
    batch: D's by its scale reading (far past the limit, though the L2 gap
    grows only a little), G's by its L2 gap (1 % of the gradient against
    bf16's 1 % noise)."""
    got = _readings(cs.STEP_GAP_BATCHES, fault=(net, 1.01))
    if net == "D":
        assert got[cs.D_SCALE] > 2 * cs.GAP_C, got
    else:
        assert got["G gradients"] > cs.GAP_C, got
    rng = np.random.default_rng(0)
    stats = [cs._step_gap_stats(*_batch(rng, fault=(net, 1.01)))
             for _ in range(cs.STEP_GAP_BATCHES)]
    with pytest.raises(AssertionError, match="kernels vs plain reads"):
        cs._compare_gap_stats(stats, "planted:")


def _old_loss_reading(stats):
    """The rule before: every loss divided by its f32 value, the losses of
    all batches as one vector (L2)."""
    losses = np.stack([st["losses"] for st in stats])
    k, p, f = (losses[..., i] / np.maximum(np.abs(losses[..., 2]), 1e-30) for i in range(3))
    return np.linalg.norm(k - p) / np.linalg.norm(p - f)


def test_a_loss_whose_value_is_near_zero_does_not_decide_the_reading():
    """A loss of 1e-9 whose noise is of the others' absolute size, and the
    kernels' 1.5 times bf16's: divided by its f32 value, as the rule before
    did, it decides the reading alone (about 1.5); counted by its own bf16
    error among the others', it is one loss of six."""
    rng = np.random.default_rng(5)
    stats = [cs._step_gap_stats(*_batch(rng, near_zero_loss=True))
             for _ in range(cs.STEP_GAP_BATCHES)]
    assert _old_loss_reading(stats) > 1.2
    assert cs.gap_readings(stats)[cs.LOSSES] <= cs.GAP_C


@pytest.mark.parametrize("fault", [("D", 1.01), ("G", 1.01), ("losses", 1.001)], ids=str)
def test_pooling_more_batches_does_not_shrink_a_systematic_fault(fault):
    """A fault moves every batch alike: its reading at 16 and 64 batches is
    no smaller than at 4 (within the noise), while the honest readings
    hold still."""
    part = {"D": cs.D_SCALE, "G": "G gradients", "losses": cs.LOSSES}[fault[0]]
    few, some, many = (_readings(n, seed=7, fault=fault)[part] for n in (4, 16, 64))
    assert some >= 0.9 * few and many >= 0.9 * few, (few, some, many)
    assert many > cs.GAP_C


def test_a_loss_bf16_leaves_exact_reads_zero_unless_the_kernels_move_it():
    rng = np.random.default_rng(8)
    k, p, f = _batch(rng)
    for m in (k, p, f):
        m["L1"] = torch.tensor(2.0, dtype=torch.float64)
    base = cs.gap_readings([cs._step_gap_stats(k, p, f)])[cs.LOSSES]
    assert np.isfinite(base)
    k["L1"] = torch.tensor(2.0 + 1e-6, dtype=torch.float64)
    assert cs.gap_readings([cs._step_gap_stats(k, p, f)])[cs.LOSSES] == np.inf
