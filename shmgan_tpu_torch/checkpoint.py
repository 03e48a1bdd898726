"""Train checkpoints and inference bundles: the counterpart of
shmgan_tpu/checkpoint.py's `CheckpointManager`, the SpecSeg files
(`save_specseg_msgpack`, `load_specseg_msgpack`, `load_specseg_weights`,
`specseg_msgpack_in_channels`, `specseg_in_channels_of`, and the
reference's Keras h5 through `load_specseg_h5`), `load_inference_bundle`,
`export_inference_bundle` and `transfer_matching_params`, without flax,
msgpack, h5py or Orbax.

A train checkpoint is one directory per step, `<dir>/<step>/state.msgpack`:
the flax msgpack (runtime/flax_msgpack.py) of `train.state.state_payload`,
the tree `flax.serialization.to_state_dict` gives for the JAX package's
Orbax payload, so `flax.serialization.from_bytes` restores it onto that
payload. A save writes a temporary directory and renames it into place, so a
step directory is whole or absent; the newest `max_to_keep` steps are kept.
Under a process group rank 0 writes and every rank restores.
The JAX package's own Orbax checkpoints are not read here: a step directory
that holds one raises with the command of `orbax_to_torch.py` (at the
repository's root, run where the JAX package and orbax are installed), which
converts them into this format.

The reference's SpecSeg is a Keras h5 (specsegv3_chkpt.h5, 1 input
channel), read through runtime/hdf5.py in any of Keras's three weight
layouts and mapped onto the flax SpecSeg tree as the JAX package maps it.

A bundle is two files: `<path>`, the flax msgpack of
{"g_params": G's params, "specseg_vars": {"params", "batch_stats"}}
(runtime/flax_msgpack.py reads and writes it), and `<path>.json`, the model
hyperparameters the weights were built with. A bundle whose header has a
`store_dtype` (float16, bfloat16) stores its floats in that dtype; they load
as float32.

    g_params, specseg_vars, header = load_inference_bundle(path)
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg)
    convert.load_inference_weights(gen, specseg, g_params, specseg_vars)
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from shmgan_tpu_torch.config import Config, ModelConfig
from shmgan_tpu_torch.convert import flax_tree
from shmgan_tpu_torch.parallel.mesh import agree_any, barrier, is_main
from shmgan_tpu_torch.runtime import flax_msgpack, hdf5

# store dtypes of a bundle's floats (bfloat16 through torch: numpy has none)
STORE_DTYPES = ("float16", "float32", "bfloat16")


def _map_floats(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    if np.issubdtype(np.asarray(tree).dtype, np.floating):
        return fn(tree)
    return tree


def _to_bfloat16(x: np.ndarray) -> flax_msgpack.BFloat16Array:
    """float32 -> bfloat16 rounded to nearest even (torch's cast, as
    ml_dtypes' astype), kept as its top 16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return flax_msgpack.BFloat16Array(t.view(torch.int16).numpy().view(np.uint16))


def _cast_floats(tree, store_dtype: str):
    if store_dtype == "bfloat16":
        return _map_floats(tree, _to_bfloat16)
    return _map_floats(tree, lambda x: x.astype(store_dtype))


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
        payload = _cast_floats(payload, store_dtype)
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


# -- train checkpoints ------------------------------------------------------

STATE_FILE = "state.msgpack"
# what an Orbax step directory of the JAX package holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default", "_METADATA")
ORBAX_CONVERTER = "orbax_to_torch.py"


class CheckpointManager:
    """Keeps the newest `max_to_keep` train checkpoints under `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)), STATE_FILE)

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first. An Orbax step directory raises."""
        steps = []
        for name in os.listdir(self.directory):
            step_dir = os.path.join(self.directory, name)
            if not (name.isdigit() and os.path.isdir(step_dir)):
                continue
            if os.path.isfile(os.path.join(step_dir, STATE_FILE)):
                steps.append(int(name))
            elif any(os.path.exists(os.path.join(step_dir, m)) for m in _ORBAX_MARKERS):
                raise NotImplementedError(
                    f"{step_dir} holds an Orbax checkpoint of the JAX package; the port "
                    f"reads its own {STATE_FILE} checkpoints only. Convert it where the "
                    f"JAX package is installed: python {ORBAX_CONVERTER} "
                    f"--checkpoint_save_dir {self.directory} --out <new dir> "
                    "<the run's model flags>")
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: Optional[int] = None) -> int:
        """Write `state` (a train.state.TrainState) at `step` (default: its
        own); a step already saved is left as it is. Under a process group
        every rank calls it: rank 0 writes, and all return once it has. A
        state cut over the model axis is gathered whole first, every rank
        joining, unless rank 0 finds the step saved."""
        from shmgan_tpu_torch.train.state import is_model_sharded, state_payload

        step = int(state.step) if step is None else int(step)
        gathered = None
        if is_model_sharded(state) and agree_any(is_main() and step not in self.all_steps()):
            gathered = state_payload(state)
        if is_main():
            self._write(lambda: state_payload(state) if gathered is None else gathered, step)
        barrier()
        return step

    def _write(self, payload: Callable[[], Dict], step: int) -> None:
        if step in self.all_steps():
            return
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            f.write(flax_msgpack.dumps(payload()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, str(step)))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def _load(self, step: int) -> Dict:
        with open(self._path(step), "rb") as f:
            return flax_msgpack.loads(f.read())

    def has_key(self, step: int, key: str) -> bool:
        """Whether the checkpoint at `step` holds the top-level entry `key`
        (e.g. "ema_g_params"); False when there is no such step."""
        if not os.path.isfile(self._path(step)):
            return False
        return key in self._load(step)

    def restore(self, template, step: Optional[int] = None, include_ema: bool = False):
        """Fill `template` (a freshly created TrainState) in place from the
        checkpoint at `step` (default: the latest) and return it; None when
        there is none. The EMA: a template without one ignores the
        checkpoint's, unless include_ema; a template with one over a
        checkpoint without one starts it from the restored G."""
        from shmgan_tpu_torch.train.state import load_state_payload

        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        if not os.path.isfile(self._path(step)):
            raise FileNotFoundError(f"no checkpoint at step {step} under {self.directory}")
        payload = self._load(step)
        want_ema = template.ema_g is not None or (include_ema and "ema_g_params" in payload)
        return load_state_payload(template, payload, with_ema=want_ema)

    def close(self) -> None:
        """Saves are synchronous; nothing is left to wait for."""


def save_specseg_msgpack(specseg_vars: Mapping, path: str) -> None:
    """Write a SpecSeg variable tree {"params", "batch_stats"} (nested dicts
    of numpy arrays, e.g. `convert.flax_tree`'s) as the bytes
    `flax.serialization.to_bytes` writes for it: keys sorted at every level,
    as a JAX tree map leaves them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.dumps(_sorted_tree(specseg_vars)))


def _sorted_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return np.asarray(tree)


def _read_specseg(path: str) -> Dict:
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: expected a SpecSeg variable tree with params")
    return tree


def specseg_msgpack_in_channels(path: str) -> int:
    """Input channels a saved SpecSeg was trained with (reads the file)."""
    return specseg_in_channels_of(_read_specseg(path))


def load_specseg_msgpack(path: str, base_filters: int = 16, image_size: int = 128,
                         in_channels: Optional[int] = None) -> Dict:
    """A SpecSeg variable tree {"params", "batch_stats"} (nested dicts of
    float32 arrays) from a file of `save_specseg_msgpack` (the JAX package's
    or the port's), read once. in_channels None: the file's own count;
    given, it must match the file. base_filters and image_size are the JAX
    signature's: the tree's own shapes decide, and loading it into a SpecSeg
    checks them."""
    del base_filters, image_size
    tree = _read_specseg(path)
    found = specseg_in_channels_of(tree)
    if in_channels is not None and in_channels != found:
        raise ValueError(f"{path}: a SpecSeg of {found} input channels, not {in_channels}")
    return _map_floats(tree, lambda x: np.asarray(x, np.float32))


# Keras layer names in the reference SpecSeg's order (SpecSeg.py:34-88): the
# 10 contracting convs with 5 BNs, 4 x (transpose + 2 convs), the 1x1 head,
# named conv2d, conv2d_1, ..., batch_normalization, ..., conv2d_transpose, ...
_FLAX_CONV_ORDER = [
    "down0/conv0", "down0/conv1", "down1/conv0", "down1/conv1",
    "down2/conv0", "down2/conv1", "down3/conv0", "down3/conv1",
    "bottom/conv0", "bottom/conv1",
    "up0/conv0", "up0/conv1", "up1/conv0", "up1/conv1",
    "up2/conv0", "up2/conv1", "up3/conv0", "up3/conv1",
    "head",
]
_FLAX_BN_ORDER = ["down0/bn", "down1/bn", "down2/bn", "down3/bn", "bottom/bn"]
_FLAX_CONVT_ORDER = ["up0_t", "up1_t", "up2_t", "up3_t"]
# Keras 3 stores a layer's weights under positional names, vars/0, vars/1, ...
_POSITIONAL = {"conv": ["kernel", "bias"],
               "bn": ["gamma", "beta", "moving_mean", "moving_variance"]}


def _keras_name(base: str, idx: int) -> str:
    return base if idx == 0 else f"{base}_{idx}"


def _collect_h5_weights(h5file: hdf5.Group) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer name: {weight short name: array}} of a Keras weight file, in
    any of its layouts: Keras 2's full-model save (`model_weights/<layer>/
    <layer>/kernel:0`, the reference's), Keras 2's save_weights (the layers
    at the root) and Keras 3's (`layers/<layer>/vars/<i>`)."""
    if "model_weights" in h5file:
        root = h5file["model_weights"]
    elif "layers" in h5file:
        root = h5file["layers"]
    else:
        root = h5file
    out = {}
    for layer_name in root:
        weights = {}

        def leaf(name, obj):
            if isinstance(obj, hdf5.Dataset):
                weights[name.split("/")[-1].split(":")[0]] = obj.read()

        group = root[layer_name]
        if isinstance(group, hdf5.Group):
            group.visititems(leaf)
        if weights and all(k.isdigit() for k in weights):
            names = _POSITIONAL["bn" if "batch_normalization" in layer_name else "conv"]
            weights = {names[int(k)]: v for k, v in weights.items()}
        if weights:
            out[layer_name] = weights
    return out


def convert_keras_convt_kernel(k_tf: np.ndarray) -> np.ndarray:
    """A Keras Conv2DTranspose kernel (kh, kw, out, in) as the flax
    ConvTranspose kernel (kh, kw, in, out) of the same function: spatially
    flipped (TF's transpose conv correlates with the flipped kernel) and
    in/out swapped."""
    return np.ascontiguousarray(k_tf[::-1, ::-1].transpose(0, 1, 3, 2))


def load_specseg_h5(path: str) -> Dict:
    """The flax SpecSeg variable tree {"params", "batch_stats"} of a Keras h5
    in the reference's topology (specsegv3_chkpt.h5), as the JAX package's
    `load_specseg_h5` gives it, leaf for leaf."""
    with hdf5.File(path) as f:
        layers = _collect_h5_weights(f)
    params: Dict = {}
    batch_stats: Dict = {}

    def set_path(tree, flax_path, leaf):
        *parents, last = flax_path.split("/")
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[last] = leaf

    def layer(base, i):
        name = _keras_name(base, i)
        if name not in layers:
            raise KeyError(f"{path}: no weights for the Keras layer {name!r} of the reference "
                           f"SpecSeg (found {sorted(layers)})")
        return layers[name]

    for i, flax_path in enumerate(_FLAX_CONV_ORDER):
        w = layer("conv2d", i)
        set_path(params, flax_path + "/kernel", w["kernel"].astype(np.float32))
        set_path(params, flax_path + "/bias", w["bias"].astype(np.float32))
    for i, flax_path in enumerate(_FLAX_BN_ORDER):
        w = layer("batch_normalization", i)
        set_path(params, flax_path + "/scale", w["gamma"].astype(np.float32))
        set_path(params, flax_path + "/bias", w["beta"].astype(np.float32))
        set_path(batch_stats, flax_path + "/mean", w["moving_mean"].astype(np.float32))
        set_path(batch_stats, flax_path + "/var", w["moving_variance"].astype(np.float32))
    for i, flax_path in enumerate(_FLAX_CONVT_ORDER):
        w = layer("conv2d_transpose", i)
        set_path(params, flax_path + "/kernel", convert_keras_convt_kernel(w["kernel"]))
        set_path(params, flax_path + "/bias", w["bias"].astype(np.float32))
    return {"params": params, "batch_stats": batch_stats}


def load_specseg_weights(path: str, base_filters: int = 16, image_size: int = 128) -> Dict:
    """A SpecSeg variable tree by the file's extension, as the JAX package
    dispatches: `.msgpack` through `load_specseg_msgpack` (in-channel count
    read from the file), anything else as the reference's Keras h5 (1 input
    channel) through `load_specseg_h5`."""
    if path.endswith(".msgpack"):
        return load_specseg_msgpack(path, base_filters=base_filters, image_size=image_size)
    return load_specseg_h5(path)


def transfer_matching_params(dst_tree: Mapping, src_tree: Mapping) -> Tuple[Dict, int, int]:
    """Copy each leaf of `src_tree` into `dst_tree` where its path exists in
    both with the same shape and dtype; keep dst's leaf elsewhere. Trees are
    flax-layout nested dicts of arrays (`convert.flax_tree`'s). Returns
    (merged tree, leaves kept from src, leaves left fresh).

    Warm starts across image sizes: G and SpecSeg are fully convolutional,
    and so is D but for its Flatten->Dense class head, the one leaf whose
    shape follows the input's extent."""
    counts = {"kept": 0, "fresh": 0}

    def merge(dst: Mapping, src) -> Dict:
        out = {}
        for k, new in dst.items():
            old = src.get(k) if isinstance(src, Mapping) else None
            if isinstance(new, Mapping):
                out[k] = merge(new, old)
            elif old is not None and not isinstance(old, Mapping) \
                    and np.shape(old) == np.shape(new) \
                    and np.asarray(old).dtype == np.asarray(new).dtype:
                counts["kept"] += 1
                out[k] = old
            else:
                counts["fresh"] += 1
                out[k] = new
        return out

    merged = merge(dst_tree, src_tree)
    return merged, counts["kept"], counts["fresh"]
