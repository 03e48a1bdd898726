"""Inference bundles: the counterpart of shmgan_tpu/checkpoint.py's
`load_inference_bundle`, `export_inference_bundle` and
`specseg_in_channels_of`, without flax or msgpack.

A bundle is two files: `<path>`, the flax msgpack of
{"g_params": G's params, "specseg_vars": {"params", "batch_stats"}}
(runtime/flax_msgpack.py reads and writes it), and `<path>.json`, the model
hyperparameters the weights were built with. A bundle whose header has a
`store_dtype` stores its floats in that dtype; they load as float32.

    g_params, specseg_vars, header = load_inference_bundle(path)
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg)
    convert.load_inference_weights(gen, specseg, g_params, specseg_vars)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from shmgan_tpu_torch.config import Config, ModelConfig
from shmgan_tpu_torch.convert import flax_tree
from shmgan_tpu_torch.runtime import flax_msgpack

# store dtypes the port's writer takes (numpy has no bfloat16)
STORE_DTYPES = ("float16", "float32")


def _map_floats(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    if np.issubdtype(np.asarray(tree).dtype, np.floating):
        return fn(tree)
    return tree


def load_inference_bundle(path: str) -> Tuple[Dict, Dict, Dict]:
    """-> (g_params, specseg_vars, header): nested dicts of numpy arrays,
    floats as float32, and the json header."""
    with open(path + ".json") as f:
        header = json.load(f)
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    if not isinstance(tree, dict) or set(tree) != {"g_params", "specseg_vars"}:
        raise ValueError(f"{path}: expected a bundle of g_params and specseg_vars, got "
                         f"{sorted(tree) if isinstance(tree, dict) else type(tree).__name__}")
    if header.get("store_dtype"):
        tree = _map_floats(tree, lambda x: np.asarray(x, np.float32))
    return tree["g_params"], tree["specseg_vars"], header


def model_config(model: ModelConfig, header: Mapping) -> ModelConfig:
    """`model` with the hyperparameters a bundle's header carries, which
    override it, so that the graph matches the weights."""
    return dataclasses.replace(
        model, image_size=header["image_size"], filter_size=header["filter_size"],
        c_dim=header["c_dim"], specseg_base_filters=header["specseg_base_filters"],
        specseg_in_channels=header.get("specseg_in_channels", 1),
        upsample_mode=header.get("upsample_mode", "conv_transpose"))


def specseg_in_channels_of(specseg_vars: Mapping) -> int:
    """Input channels of a SpecSeg variable tree, from its first conv
    kernel's shape (HWIO)."""
    return int(np.shape(specseg_vars["params"]["down0"]["conv0"]["kernel"])[2])


def export_inference_bundle(gen: torch.nn.Module, specseg: torch.nn.Module, cfg: Config,
                            path: str, step: int, store_dtype: Optional[str] = None) -> None:
    """Write `<path>` and `<path>.json` from the port's G and SpecSeg, with
    the header fields the JAX package writes."""
    if store_dtype is not None and store_dtype not in STORE_DTYPES:
        raise ValueError(f"store_dtype must be one of {STORE_DTYPES} or None, got "
                         f"{store_dtype!r}")
    params, batch_stats = flax_tree(specseg)
    # keys sorted at every level, as the JAX package's export leaves them
    payload = {"g_params": flax_tree(gen)[0],
               "specseg_vars": {"batch_stats": batch_stats, "params": params}}
    if store_dtype is not None:
        payload = _map_floats(payload, lambda x: x.astype(store_dtype))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.dumps(payload))
    m = cfg.model
    header = {"step": int(step), "image_size": m.image_size, "filter_size": m.filter_size,
              "c_dim": m.c_dim, "specseg_base_filters": m.specseg_base_filters,
              "specseg_in_channels": m.specseg_in_channels, "upsample_mode": m.upsample_mode}
    if store_dtype is not None:
        header["store_dtype"] = str(store_dtype)
    with open(path + ".json", "w") as f:
        json.dump(header, f, indent=1)
