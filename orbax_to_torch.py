"""Converts the JAX package's Orbax train checkpoints into the PyTorch port's.

    python orbax_to_torch.py --checkpoint_save_dir ckpt/ --out ckpt_torch/ \
        [--step 1200] <the run's model and training flags>

Runs where the JAX package and orbax are installed. It takes the JAX command
line's own flags (`shmgan_tpu.config.Config.from_args`), so that
`create_train_state` builds the template the checkpoint was saved from
(shapes only: `jax.eval_shape`), and restores each step under
--checkpoint_save_dir (or only --step) through the JAX package's
`CheckpointManager.restore`, with `ema_g_params` where the step has it. Each
step is written as `<out>/<step>/state.msgpack`: the flax msgpack of
`flax.serialization.to_state_dict` of the restored payload (step, g_params,
d_params, specseg_vars, g_opt_state, d_opt_state[, ema_g_params]), the
format of `shmgan_tpu_torch.checkpoint.CheckpointManager`, through a
temporary directory renamed into place. A step already under --out is left
as it is.

The port's `--checkpoint_save_dir <out>` then resumes, tests, exports or
serves from it. This script is the one file outside tests/ that imports both
packages; the port never imports it.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import List, Optional


def _template(cfg):
    import jax
    import jax.numpy as jnp

    from shmgan_tpu.train.state import create_train_state

    shapes = jax.eval_shape(lambda: create_train_state(cfg, jax.random.PRNGKey(cfg.train.seed)))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def payload_of(state) -> dict:
    """The restored state as the tree both managers save."""
    payload = {"step": state.step, "g_params": state.g_params, "d_params": state.d_params,
               "specseg_vars": state.specseg_vars, "g_opt_state": state.g_opt_state,
               "d_opt_state": state.d_opt_state}
    if state.ema_g_params is not None:
        payload["ema_g_params"] = state.ema_g_params
    return payload


def convert(cfg, out: str, step: Optional[int] = None) -> List[int]:
    """Convert `step` (default: every step) of cfg.train.checkpoint_save_dir
    into `out`; the steps written."""
    import flax.serialization
    import jax

    from shmgan_tpu.checkpoint import CheckpointManager
    from shmgan_tpu_torch.checkpoint import STATE_FILE

    src = CheckpointManager(cfg.train.checkpoint_save_dir)
    try:
        steps = src._mgr.all_steps() if step is None else [int(step)]
        if not steps:
            raise FileNotFoundError(f"no Orbax checkpoint under {src.directory}")
        template = _template(cfg)
        os.makedirs(out, exist_ok=True)
        written = []
        for s in sorted(steps):
            final = os.path.join(out, str(s))
            if os.path.isfile(os.path.join(final, STATE_FILE)):
                print(f"[convert] step {s}: {final} exists, left as it is", flush=True)
                continue
            state = src.restore(template, step=s, include_ema=True)
            data = flax.serialization.to_bytes(jax.device_get(payload_of(state)))
            tmp = os.path.join(out, f".tmp-{s}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            written.append(s)
            print(f"[convert] step {s} -> {os.path.join(final, STATE_FILE)} ({len(data)} bytes"
                  f"{', with the EMA generator' if state.ema_g_params is not None else ''})",
                  flush=True)
        return written
    finally:
        src.close()


def main(argv: Optional[List[str]] = None) -> List[int]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], add_help=False)
    p.add_argument("--out", required=True, help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="one step (default: every step)")
    a, rest = p.parse_known_args(argv)
    from shmgan_tpu.config import Config

    return convert(Config.from_args(rest), a.out, a.step)


if __name__ == "__main__":
    main(sys.argv[1:])
