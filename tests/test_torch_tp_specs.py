"""Which parameters the port cuts over the model axis, against the JAX
package's `param_shardings`, at the JAX defaults' widths (filter 64) and at
32, 128 and 256 px, for a model axis of 2 and 4 and tp_min_channels 256
and 64. JAX's parameter shapes come from `jax.eval_shape` (no step runs);
the port's from G and D built on the meta device (no data).

`mesh.param_spec` over the port's flax tree (`convert.flax_shapes`) gives
JAX's spec leaf for leaf, and `tp.shard_model_` cuts exactly the blocks
whose kernels JAX splits, each to 1/M of its output channels (or, for D's
class head, of its input rows). `shard_tree` and `gather_tree` carry a
tree to the ranks' slices and back.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from shmgan_tpu.parallel.mesh import param_shardings
from shmgan_tpu.train.state import create_train_state as j_create_train_state
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import flax_shapes, gather_tree, shard_tree
from shmgan_tpu_torch.models import SHMDiscriminator, SHMGenerator
from shmgan_tpu_torch.parallel import tp
from shmgan_tpu_torch.parallel.mesh import Mesh, RankLayout, param_specs


@functools.lru_cache(maxsize=None)
def _jax_shapes(size):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=size)
    return jax.eval_shape(lambda: j_create_train_state(jcfg, jax.random.PRNGKey(0)))


def _port_models(size):
    m = Config().model
    with torch.device("meta"):
        return {"G": SHMGenerator(filter_size=m.filter_size, c_dim=m.c_dim,
                                  upsample_mode=m.upsample_mode),
                "D": SHMDiscriminator(filter_size=m.filter_size, c_dim=m.c_dim,
                                      image_size=size)}


def _jax_specs(size, mp, min_channels):
    jcfg = JConfig()
    jcfg.mesh = dataclasses.replace(jcfg.mesh, model_parallel=mp)
    mesh = j_make_mesh(jcfg)
    shapes = _jax_shapes(size)
    return {net: jax.tree_util.tree_map(
        lambda s: tuple(s.spec),
        param_shardings(tree, mesh, image_size=size, min_channels=min_channels))
        for net, tree in (("G", shapes.g_params), ("D", shapes.d_params))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


CASES = [(size, mp, mc) for size in (32, 128, 256) for mp in (2, 4) for mc in (256, 64)]


@pytest.mark.parametrize("size,mp,min_channels", CASES)
def test_specs_match_jax_param_shardings(size, mp, min_channels):
    want = _jax_specs(size, mp, min_channels)
    for net, model in _port_models(size).items():
        got = _flat(param_specs(flax_shapes(model), mp, size, min_channels))
        assert got == _flat(dict(want[net])), net


@pytest.mark.parametrize("size,mp,min_channels", CASES)
def test_shard_model_cuts_the_kernels_jax_splits(size, mp, min_channels):
    want = _jax_specs(size, mp, min_channels)
    for net, model in _port_models(size).items():
        whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
        layout = RankLayout(Mesh(1, mp), model_index=mp - 1)
        cut = tp.shard_model_(model, layout, size, min_channels)
        assert cut == tp.sharded_params(model)
        split = {path for path, spec in _flat(dict(want[net])).items() if "model" in spec}
        kernels = {k.rsplit(".", 1)[0].replace(".", "/") + "/kernel" for k in cut
                   if k.endswith(".weight")}
        assert kernels == split, net
        for k, p in model.named_parameters():
            shape = list(whole[k])
            if k in cut:
                shape[cut[k]] //= mp
            assert tuple(p.shape) == tuple(shape), k
        assert all(m.tp is layout for m in model.modules() if getattr(m, "tp", None))


def test_default_widths_cut_sixteen_g_kernels_and_d_class_rows():
    """At the JAX defaults (128 px, filter 64, tp_min_channels 256) on 2
    model ranks: 16 of G's kernels and 20.29 M of its 21.68 M parameters'
    kernels sit on cut leaves; D's blocks 2-4, its attention and its class
    head by input rows: 6 kernels, 8.64 M of 8.73 M."""
    specs = _jax_specs(128, 2, 256)
    shapes = _jax_shapes(128)
    for net, tree, n_kernels, cut_m in (("G", shapes.g_params, 16, 20.29),
                                        ("D", shapes.d_params, 6, 8.64)):
        flat_specs, flat_shapes = _flat(dict(specs[net])), _flat(dict(tree))
        split = [p for p, s in flat_specs.items() if "model" in s]
        assert len(split) == n_kernels, net
        cut = sum(int(np.prod(flat_shapes[p].shape)) for p in split)
        assert round(cut / 1e6, 2) == cut_m, (net, cut)
    assert specs["D"]["out_class"]["kernel"] == ("model", None)


def test_shard_and_gather_tree_round_trip():
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.random((3, 3, 4, 8), np.float32),
                  "bias": rng.random(8, np.float32)},
            "head": {"kernel": rng.random((2048, 5), np.float32)}}
    specs = {"a": {"kernel": (None, None, None, "model"), "bias": ()},
             "head": {"kernel": ("model", None)}}
    parts = [shard_tree(tree, specs, j, 4) for j in range(4)]
    assert parts[1]["a"]["kernel"].shape == (3, 3, 4, 2)
    assert parts[3]["head"]["kernel"].shape == (512, 5)
    np.testing.assert_array_equal(parts[2]["a"]["kernel"], tree["a"]["kernel"][..., 4:6])
    np.testing.assert_array_equal(parts[2]["a"]["bias"], tree["a"]["bias"])
    back = gather_tree(parts, specs)
    for path, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[path], v)
