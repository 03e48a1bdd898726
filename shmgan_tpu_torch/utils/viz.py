"""Model summaries: the counterpart of shmgan_tpu/utils/viz.py's
`model_summary` and `write_model_summaries`. They read flax-layout trees
(nested dicts of arrays, as `convert.flax_tree` lays a module out), so the
text is the JAX package's, line for line, for the same configuration.
(viz.py's matplotlib plots and its hdf5 dump are not ported.)
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping, Tuple

import numpy as np


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in sorted key order at every level, as a JAX tree
    flatten walks a dict."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def model_summary(params: Mapping, name: str = "model") -> str:
    """A keras-summary-style table of a parameter tree: one row per leaf
    (path, shape, count) and the total."""
    lines = [f'Model: "{name}"', "=" * 64,
             f"{'Path':<44}{'Shape':<14}Params", "-" * 64]
    total = 0
    for key, leaf in _leaves(params):
        shape = tuple(int(d) for d in np.shape(leaf))
        n = int(np.prod(shape)) if shape else 1
        total += n
        lines.append(f"{key:<44}{str(shape):<14}{n:,}")
    lines += ["=" * 64, f"Total params: {total:,}"]
    return "\n".join(lines)


def write_model_summaries(g_params: Mapping, d_params: Mapping, specseg_vars: Mapping,
                          out_dir: str = ".") -> None:
    """Generator_summary.txt, Discriminator_summary.txt and SpecSeg_summary.txt
    under `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    for fname, tree, name in (
            ("Generator_summary.txt", g_params, "SHM_Generator"),
            ("Discriminator_summary.txt", d_params, "SHM_Discriminator"),
            ("SpecSeg_summary.txt", specseg_vars, "SpecSeg")):
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(model_summary(tree, name) + "\n")
