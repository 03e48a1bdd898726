"""The JAX package's own bf16 train step on a 1 x 2 (data, model) mesh
against its one-device bf16 step, by chip_smoke.py's gap measure, on the CPU.

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/tp_gap_jax.py [--batches 4]

At tests/test_torch_tp_train.py's size (128 px, filter 8, SpecSeg base 4,
batch 4, tp_min_channels 32: G's levels 2-3, its bottleneck and up levels
0-1, D's blocks 2-4, its attention and its class head cut) and its seeded
weights (test_torch_train_loop._seeded_jax_state), the same step with
debug_grads runs on each of --batches seeded batches as: one device in f32,
one device in bf16, and the 1 x 2 mesh in bf16 (`shard_train_state`,
`shard_batch`), each compiled with XLA's excess precision off, as
tests/test_torch_bf16.py compiles JAX. For G's gradients, D's gradients and
the losses scaled by their f32 values it prints ||mesh - one|| / ||one -
f32|| per batch and over all of them, and ||mesh - f32|| / ||one - f32||,
then one JSON line.
"""

import argparse
import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dp_train import BATCH, SIZE, _configs  # noqa: E402
from test_torch_train_loop import _seeded_jax_state  # noqa: E402

from shmgan_tpu.parallel.mesh import make_mesh, shard_batch, shard_train_state  # noqa: E402
from shmgan_tpu.train.step import make_train_step  # noqa: E402

MIN_CHANNELS = 32
LOSSES = "losses (each scaled by its f32 value)"


def _config(dtype, mp):
    jcfg, _ = _configs()
    return dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, compute_dtype=dtype),
        mesh=dataclasses.replace(jcfg.mesh, data_parallel=1, model_parallel=mp,
                                 tp_min_channels=MIN_CHANNELS))


def _step(jcfg, state, views, key, mesh=None):
    fn = jax.jit(make_train_step(jcfg, debug_grads=True))
    args = (state, views, key, jnp.zeros((), jnp.int32))
    if mesh is not None:
        args = (shard_train_state(state, mesh, image_size=SIZE, min_channels=MIN_CHANNELS),
                shard_batch(views, mesh), key, args[3])
    _, m = fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    return jax.device_get(m)


def _vectors(m, f32):
    keys = sorted(k for k in f32 if not k.startswith("_") and k != "target_label")
    out = {f"{net} gradients": np.concatenate([
        np.asarray(leaf, np.float64).ravel()
        for _, leaf in sorted(jax.tree_util.tree_flatten_with_path(m["_grads"][net])[0],
                              key=lambda kv: jax.tree_util.keystr(kv[0]))])
        for net in ("G", "D")}
    out[LOSSES] = np.array([float(m[k]) / max(abs(float(f32[k])), 1e-30) for k in keys])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)

    state = jax.tree_util.tree_map(jnp.asarray, _seeded_jax_state(_config("float32", 1)))
    mesh = make_mesh(_config("bfloat16", 2))
    rows = []
    for i in range(args.batches):
        views = jnp.asarray(np.random.default_rng(100 + i).random((5, BATCH, SIZE, SIZE, 3),
                                                                   np.float32))
        key = jax.random.PRNGKey(42 + i)
        f32 = _step(_config("float32", 1), state, views, key)
        one = _step(_config("bfloat16", 1), state, views, key)
        two = _step(_config("bfloat16", 2), state, views, key, mesh)
        for m in (one, two):
            assert np.array_equal(m["target_label"], f32["target_label"])
        v = {name: _vectors(m, f32) for name, m in (("f32", f32), ("one", one), ("mesh", two))}
        rows.append({part: {pair: float(np.sum((v[a][part] - v[b][part]) ** 2))
                            for pair, (a, b) in (("mesh vs one", ("mesh", "one")),
                                                 ("one vs f32", ("one", "f32")),
                                                 ("mesh vs f32", ("mesh", "f32")))}
                     for part in v["f32"]})
        print(f"batch {i}: " + "; ".join(
            f"{part} {np.sqrt(r['mesh vs one'] / r['one vs f32']):.3f}"
            for part, r in rows[-1].items()), flush=True)
    summary = {}
    for part in rows[0]:
        den = sum(r[part]["one vs f32"] for r in rows)
        summary[part] = {
            "mesh vs one": float(np.sqrt(sum(r[part]["mesh vs one"] for r in rows) / den)),
            "mesh vs f32": float(np.sqrt(sum(r[part]["mesh vs f32"] for r in rows) / den)),
            "batches": [float(np.sqrt(r[part]["mesh vs one"] / r[part]["one vs f32"]))
                        for r in rows]}
        print(f"{part}: ||mesh - one|| / ||one - f32|| {summary[part]['mesh vs one']:.3f} "
              f"over {len(rows)} batches; ||mesh - f32|| / ||one - f32|| "
              f"{summary[part]['mesh vs f32']:.3f}", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
