"""Weight bridge: flax parameter trees (nested dicts of numpy arrays, as
`shmgan_tpu.checkpoint.load_inference_bundle` or a flax `.init` returns them)
into the port's modules.

Layouts:
  conv kernel            (kh, kw, in, out) -> weight (out, in, kh, kw)
  transposed-conv kernel (kh, kw, in, out) -> flipped in space, (in, out, kh, kw)
  InstanceNorm           scale / bias      -> scale / bias (gamma / beta)
  BatchNorm              scale / bias      -> weight / bias;
                         batch_stats mean / var -> running_mean / running_var

Every parameter and buffer of the module must be filled exactly once, and
every leaf of the tree must land somewhere: anything left over or missing
raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

_LEAF_NAMES = {
    nn.Conv2d: {"kernel": "weight", "bias": "bias"},
    nn.ConvTranspose2d: {"kernel": "weight", "bias": "bias"},
    nn.BatchNorm2d: {"scale": "weight", "bias": "bias", "mean": "running_mean",
                     "var": "running_var"},
}


def _torch_layout(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if isinstance(module, nn.ConvTranspose2d):
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    return value.transpose(3, 2, 0, 1)


def _walk(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def load_flax(module: nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill `module` in place from flax `params` (and `batch_stats`)."""
    targets: Dict[str, torch.Tensor] = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    filled = set()
    leaves = list(_walk(params)) + list(_walk(batch_stats or {}))
    with torch.no_grad():
        for path, value in leaves:
            owner_path, _, leaf = path.rpartition(".")
            owner = module.get_submodule(owner_path)
            name = _LEAF_NAMES.get(type(owner), {}).get(leaf, leaf)
            target = f"{owner_path}.{name}" if owner_path else name
            if target not in targets:
                raise KeyError(f"flax leaf {path} has no counterpart {target} in "
                               f"{type(module).__name__}")
            if target in filled:
                raise KeyError(f"flax leaf {path} fills {target} twice")
            arr = _torch_layout(owner, leaf, np.asarray(value, np.float32))
            dst = targets[target]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: flax shape {np.shape(value)} does not "
                                 f"fit {target} of shape {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(arr.copy()))
            filled.add(target)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    return module


def load_inference_weights(gen: nn.Module, specseg: nn.Module, g_params: Mapping,
                           specseg_vars: Mapping) -> None:
    """Fill G from `g_params` and SpecSeg from `{"params", "batch_stats"}`."""
    load_flax(gen, g_params)
    extra = set(specseg_vars) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected SpecSeg collections {sorted(extra)}")
    load_flax(specseg, specseg_vars["params"], specseg_vars.get("batch_stats"))
