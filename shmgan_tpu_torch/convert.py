"""Weight bridge between flax parameter trees (nested dicts of numpy arrays,
as `shmgan_tpu.checkpoint.load_inference_bundle` or a flax `.init` returns
them) and the port's modules: `load_flax` fills a module from a tree,
`to_flax` lays named tensors of a module (its parameters, their gradients or
optimizer moments) out as the tree they came from, and `flax_tree` lays a
module's own parameters and buffers out as its flax variables.

Layouts:
  conv kernel            (kh, kw, in, out) -> weight (out, in, kh, kw)
  transposed-conv kernel (kh, kw, in, out) -> flipped in space, (in, out, kh, kw)
  Dense kernel           (in, out)          -> Linear weight (out, in)
  InstanceNorm           scale / bias      -> scale / bias (gamma / beta)
  BatchNorm              scale / bias      -> weight / bias;
                         batch_stats mean / var -> running_mean / running_var

Every parameter and buffer of the module must be filled exactly once, and
every leaf of the tree must land somewhere: anything left over or missing
raises.

Tensor parallelism (parallel/tp.py): `shard_tree` cuts a flax tree into
model rank j's slices by a tree of PartitionSpec tuples
(`parallel.mesh.param_specs`), and `gather_tree` joins the ranks' slices
back; `flax_shapes` gives a module's flax leaf shapes without its data.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF_NAMES = {
    nn.Conv2d: {"kernel": "weight", "bias": "bias"},
    nn.ConvTranspose2d: {"kernel": "weight", "bias": "bias"},
    nn.Linear: {"kernel": "weight", "bias": "bias"},
    nn.BatchNorm2d: {"scale": "weight", "bias": "bias", "mean": "running_mean",
                     "var": "running_var"},
}


_FLAX_NAMES = {cls: {t: f for f, t in names.items()} for cls, names in _LEAF_NAMES.items()}


# the flax kernel axis that each torch weight axis holds
_KERNEL_AXES = {nn.Conv2d: (3, 2, 0, 1), nn.ConvTranspose2d: (2, 3, 0, 1), nn.Linear: (1, 0)}


def kernel_axes(module: nn.Module) -> Tuple[int, ...]:
    """For each axis of `module`'s torch weight, the axis of its flax kernel
    it holds: torch axis d is flax axis kernel_axes(module)[d]."""
    return _KERNEL_AXES.get(type(module), (3, 2, 0, 1))


def _torch_layout(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if isinstance(module, nn.ConvTranspose2d):
        value = value[::-1, ::-1]
    return value.transpose(kernel_axes(module))


def _flax_layout(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    """The inverse of _torch_layout."""
    if leaf != "kernel":
        return value
    value = value.transpose(np.argsort(kernel_axes(module)))
    return value[::-1, ::-1] if isinstance(module, nn.ConvTranspose2d) else value


def _walk(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def _resolve(module: nn.Module, path: str):
    """(owning submodule, flax leaf name, torch name) of a flax leaf path."""
    owner_path, _, leaf = path.rpartition(".")
    owner = module.get_submodule(owner_path)
    name = _LEAF_NAMES.get(type(owner), {}).get(leaf, leaf)
    return owner, leaf, f"{owner_path}.{name}" if owner_path else name


def from_flax(module: nn.Module, tree: Mapping) -> Dict[str, np.ndarray]:
    """The leaves of a flax tree of `module` (its params or batch_stats, or
    tensors laid out like them, e.g. optimizer moments) by torch name, as
    float32 arrays in torch layout. The inverse of `to_flax`."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _walk(tree):
        owner, leaf, target = _resolve(module, path)
        if target in out:
            raise KeyError(f"flax leaf {path} fills {target} twice")
        out[target] = np.array(_torch_layout(owner, leaf, np.asarray(value, np.float32)),
                               order="C")
    return out


def load_flax(module: nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill `module` in place from flax `params` (and `batch_stats`)."""
    targets: Dict[str, torch.Tensor] = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    arrays = from_flax(module, params)
    for name, arr in from_flax(module, batch_stats or {}).items():
        if name in arrays:
            raise KeyError(f"{name} is both a param and a batch stat")
        arrays[name] = arr
    with torch.no_grad():
        for name, arr in arrays.items():
            if name not in targets:
                raise KeyError(f"flax leaf for {name} has no counterpart in "
                               f"{type(module).__name__}")
            dst = targets[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: flax leaf of torch shape {arr.shape} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(arr))
    missing = sorted(set(targets) - set(arrays))
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    return module


def to_flax(module: nn.Module, template: Mapping,
            named: Mapping[str, torch.Tensor]) -> Dict:
    """`named` (torch name -> tensor of `module`, e.g. its gradients) as a
    nested dict of numpy arrays shaped like the flax tree `template`: copies,
    never views of the tensors (on the CPU a view would change with them)."""
    out: Dict = {}
    for path, _ in _walk(template):
        owner, leaf, target = _resolve(module, path)
        value = named[target].detach().cpu().numpy()
        node = out
        *parents, key = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = np.array(_flax_layout(owner, leaf, value), order="C")
    return out


def flax_tree(module: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats): every parameter and buffer of `module` as the
    nested dicts of numpy arrays its flax counterpart holds, keys sorted at
    every level, as a JAX tree map leaves a dict; copies, never views. The
    inverse of `load_flax`."""
    params: Dict = {}
    batch_stats: Dict = {}
    tensors = list(module.named_parameters()) + [
        (n, b) for n, b in module.named_buffers() if not n.endswith("num_batches_tracked")]
    for name, tensor in tensors:
        owner_path, _, torch_leaf = name.rpartition(".")
        owner = module.get_submodule(owner_path)
        leaf = _FLAX_NAMES.get(type(owner), {}).get(torch_leaf, torch_leaf)
        node = batch_stats if torch_leaf.startswith("running_") else params
        for part in owner_path.split(".") if owner_path else []:
            node = node.setdefault(part, {})
        node[leaf] = np.array(
            _flax_layout(owner, leaf, tensor.detach().cpu().float().numpy()), order="C")
    return _sorted(params), _sorted(batch_stats)


def _sorted(tree: Dict) -> Dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def flax_shapes(module: nn.Module) -> Dict:
    """The flax params tree of `module` with each leaf's shape (a tuple) in
    place of its array; reads no data (a module on the meta device will do)."""
    tree: Dict = {}
    for name, tensor in module.named_parameters():
        owner_path, _, torch_leaf = name.rpartition(".")
        owner = module.get_submodule(owner_path)
        leaf = _FLAX_NAMES.get(type(owner), {}).get(torch_leaf, torch_leaf)
        node = tree
        for part in owner_path.split(".") if owner_path else []:
            node = node.setdefault(part, {})
        shape = tuple(tensor.shape)
        if leaf == "kernel":
            shape = tuple(shape[a] for a in np.argsort(kernel_axes(owner)))
        node[leaf] = shape
    return _sorted(tree)


def _model_axis(spec: Sequence) -> Optional[int]:
    return tuple(spec).index("model") if "model" in spec else None


def shard_tree(tree: Mapping, specs: Mapping, index: int, count: int) -> Dict:
    """Model rank `index`'s slice, of `count`, of each leaf of a flax tree
    of numpy arrays: block `index` of the axis its spec (a tree of the same
    keys, `parallel.mesh.param_specs`) names "model"; the whole leaf where
    the spec names none. Copies, never views."""
    out: Dict = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = shard_tree(val, specs[key], index, count)
            continue
        val = np.asarray(val)
        axis = _model_axis(specs[key])
        if axis is not None:
            n = val.shape[axis] // count
            val = np.take(val, np.arange(index * n, (index + 1) * n), axis=axis)
        out[key] = np.array(val, order="C")
    return out


def gather_tree(trees: Sequence[Mapping], specs: Mapping) -> Dict:
    """The inverse of `shard_tree`: the model ranks' trees, in model index
    order, joined along each leaf's model axis; a leaf whole on every rank
    is rank 0's."""
    out: Dict = {}
    for key, val in trees[0].items():
        if isinstance(val, Mapping):
            out[key] = gather_tree([t[key] for t in trees], specs[key])
            continue
        axis = _model_axis(specs[key])
        out[key] = (np.array(val, order="C") if axis is None
                    else np.concatenate([np.asarray(t[key]) for t in trees], axis=axis))
    return out


def load_inference_weights(gen: nn.Module, specseg: nn.Module, g_params: Mapping,
                           specseg_vars: Mapping) -> None:
    """Fill G from `g_params` and SpecSeg from `{"params", "batch_stats"}`."""
    load_flax(gen, g_params)
    extra = set(specseg_vars) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected SpecSeg collections {sorted(extra)}")
    load_flax(specseg, specseg_vars["params"], specseg_vars.get("batch_stats"))
