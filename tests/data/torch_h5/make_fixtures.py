"""Writes this directory's Keras SpecSeg fixture with h5py, and its README.

    PYTHONPATH=. python tests/data/torch_h5/make_fixtures.py

`specseg_keras2.h5` is the reference's SpecSeg (base 16, 1 input channel,
1,942,801 float32 values) in the layout Keras 2 writes for a full model
(`model.save("specsegv3_chkpt.h5")`): the root attributes `keras_version`,
`backend` and `model_config`; `model_weights` with `layer_names`, one group
per layer with its `weight_names` (empty on input, dropout, pooling and
concatenate layers) and the weights at `<layer>/<layer>/<weight>:0`; an
`optimizer_weights` group. The weights are drawn from numpy (seed 2015) on
the flax SpecSeg tree's shapes and mapped back to Keras's names and kernel
layouts by inverting the JAX package's orders and
`convert_keras_convt_kernel`.

`write_keras_h5` also writes Keras 2's save_weights layout (the layers at the
root) and Keras 3's (`layers/<layer>/vars/<i>`); the tests call it at a
narrow width.
"""

import hashlib
import json
import math
import os

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = "specseg_keras2.h5"
SEED = 2015
LAYOUTS = ("keras2_model", "keras2_weights", "keras3")


def specseg_shapes(base: int, in_channels: int = 1):
    """The flax SpecSeg variable tree's leaf shapes, {path: shape}."""
    import flax
    import jax
    import jax.numpy as jnp

    from shmgan_tpu.models import SpecSeg

    tree = jax.eval_shape(lambda: SpecSeg(base_filters=base).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, in_channels), jnp.float32),
        train=False))
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {"/".join(k): tuple(v.shape) for k, v in flat.items()}


def seeded_vars(base: int, in_channels: int = 1, seed: int = SEED):
    """A SpecSeg variable tree of seeded float32 leaves: kernels N(0, 1/fan_in),
    biases N(0, 0.01^2), BN scale 1 + N(0, 0.1^2), bias and mean N(0, 0.1^2),
    var 0.5 + |N(0, 0.5^2)|."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in specseg_shapes(base, in_channels).items():
        v = rng.standard_normal(shape)
        last = path.split("/")[-1]
        if last == "kernel":
            v = v / math.sqrt(np.prod(shape[:-1]))
        elif last == "scale":
            v = 1.0 + 0.1 * v
        elif last == "var":
            v = 0.5 + 0.5 * np.abs(v)
        elif last == "bias" and "/bn/" not in f"/{path}":
            v = 0.01 * v
        else:
            v = 0.1 * v
        out[path] = v.astype(np.float32)
    tree = {}
    for path, leaf in out.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def keras_layers(specseg_vars):
    """[(Keras layer name, [(weight name, array)])] in the reference model's
    layer order, weightless layers included."""
    from shmgan_tpu.checkpoint import (_FLAX_BN_ORDER, _FLAX_CONV_ORDER, _FLAX_CONVT_ORDER,
                                       _keras_name)

    p, s = specseg_vars["params"], specseg_vars["batch_stats"]

    def get(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    def conv(i):
        name = _keras_name("conv2d", i)
        return name, [("kernel", get(p, _FLAX_CONV_ORDER[i] + "/kernel")),
                      ("bias", get(p, _FLAX_CONV_ORDER[i] + "/bias"))]

    def bn(i):
        at = _FLAX_BN_ORDER[i]
        return _keras_name("batch_normalization", i), [
            ("gamma", get(p, at + "/scale")), ("beta", get(p, at + "/bias")),
            ("moving_mean", get(s, at + "/mean")), ("moving_variance", get(s, at + "/var"))]

    def convt(i):
        k = get(p, _FLAX_CONVT_ORDER[i] + "/kernel")
        # convert_keras_convt_kernel flips and swaps in/out; it is its own inverse
        k_tf = np.ascontiguousarray(k[::-1, ::-1].transpose(0, 1, 3, 2))
        return _keras_name("conv2d_transpose", i), [
            ("kernel", k_tf), ("bias", get(p, _FLAX_CONVT_ORDER[i] + "/bias"))]

    layers, c, d, m = [("input_1", [])], 0, 0, 0
    for level in range(5):                      # Conv, Dropout, Conv, BN (, MaxPool)
        layers += [conv(c), (_keras_name("dropout", d), []), conv(c + 1), bn(level)]
        c, d = c + 2, d + 1
        if level < 4:
            layers.append((_keras_name("max_pooling2d", m), []))
            m += 1
    for j in range(4):                          # ConvT, concat, Conv, Dropout, Conv
        layers += [convt(j), (_keras_name("concatenate", j), []), conv(c),
                   (_keras_name("dropout", d), []), conv(c + 1)]
        c, d = c + 2, d + 1
    layers.append(conv(c))                      # the 1x1 sigmoid head
    return layers


def _model_config(layers):
    kinds = {"input": "InputLayer", "conv2d_transpose": "Conv2DTranspose", "conv2d": "Conv2D",
             "dropout": "Dropout", "batch_normalization": "BatchNormalization",
             "max_pooling2d": "MaxPooling2D", "concatenate": "Concatenate"}

    def kind(name):
        return next(v for k, v in kinds.items() if name.startswith(k))

    return json.dumps({"class_name": "Functional", "config": {
        "name": "model", "layers": [{"class_name": kind(n), "name": n} for n, _ in layers]}})


def write_keras_h5(path, specseg_vars, layout="keras2_model"):
    """Write `specseg_vars` as Keras writes the reference SpecSeg in
    `layout` (one of LAYOUTS)."""
    layers = keras_layers(specseg_vars)
    with h5py.File(path, "w") as f:
        if layout == "keras3":
            top = f.create_group("layers")
            for name, weights in layers:
                g = top.create_group(name).create_group("vars")
                for i, (_, w) in enumerate(weights):
                    g.create_dataset(str(i), data=w)
            f.create_group("optimizer").create_group("vars").create_dataset(
                "0", data=np.int64(0))
            f.create_group("vars")
            return
        if layout == "keras2_model":
            f.attrs["keras_version"] = b"2.8.0"
            f.attrs["backend"] = b"tensorflow"
            f.attrs["model_config"] = _model_config(layers).encode()
            root = f.create_group("model_weights")
        else:
            root = f
        root.attrs["layer_names"] = [n.encode() for n, _ in layers]
        root.attrs["backend"] = b"tensorflow"
        root.attrs["keras_version"] = b"2.8.0"
        for name, weights in sorted(layers):
            g = root.create_group(name)
            g.attrs["weight_names"] = [f"{name}/{w}:0".encode() for w, _ in weights]
            for w, value in weights:
                g.create_dataset(f"{name}/{w}:0", data=value)
        if layout == "keras2_model":
            opt = f.create_group("optimizer_weights")
            head, head_kernel = layers[-1][0], layers[-1][1][0][1]
            opt.attrs["weight_names"] = [b"Adam/iter:0", f"Adam/{head}/kernel/m:0".encode()]
            opt.create_dataset("Adam/iter:0", data=np.int64(1000))
            opt.create_dataset(f"Adam/{head}/kernel/m:0", data=np.zeros_like(head_kernel))


def leaf_sums(tree, prefix=""):
    """{path: (shape, float64 sum, float64 sum of squares)} of every leaf,
    each sum exactly rounded (math.fsum; a float32's square is exact in
    float64)."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.update(leaf_sums(tree[key], path))
        else:
            x = np.asarray(tree[key], np.float64).ravel()
            out[path] = (tuple(np.shape(tree[key])), math.fsum(x), math.fsum(x * x))
    return out


def main():
    specseg_vars = seeded_vars(16, 1)
    path = os.path.join(HERE, FIXTURE)
    write_keras_h5(path, specseg_vars, "keras2_model")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    sums = leaf_sums(specseg_vars)
    n = sum(int(np.prod(s)) for s, _, _ in sums.values())
    lines = [
        "# Keras SpecSeg fixture",
        "",
        f"`{FIXTURE}`: the reference's SpecSeg (base 16, 1 input channel, {n:,} float32",
        "values, seeded) in Keras 2's full-model h5 layout, written by h5py through",
        "`make_fixtures.py` (see its docstring):",
        "",
        "    PYTHONPATH=. python tests/data/torch_h5/make_fixtures.py",
        "",
        f"sha256 `{digest}`",
        "",
        "Each leaf of the flax SpecSeg tree the file loads as, its shape and its",
        "float64 sum and sum of squares, each exactly rounded (`math.fsum`):",
        "",
        "| leaf | shape | sum | sum of squares |",
        "|---|---|---|---|",
    ]
    for leaf, (shape, s1, s2) in sums.items():
        lines.append(f"| {leaf} | {shape} | {s1!r} | {s2!r} |")
    with open(os.path.join(HERE, "README.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{path}: {os.path.getsize(path)} bytes, {n} values, sha256 {digest}")


if __name__ == "__main__":
    main()
