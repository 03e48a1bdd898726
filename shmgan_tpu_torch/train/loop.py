"""The training driver: the epoch loop around the fused step (the
counterpart of shmgan_tpu/train/loop.py).

    state = train(cfg)                          # on the CUDA card
    state = train(cfg, device="cpu")            # on the CPU, plain versions

It loads the polarimetric dataset, builds (G, D, SpecSeg) from
`cfg.train.seed` (SpecSeg from `cfg.eval.specseg_weights` when that file
exists), writes the model summaries, restores the latest checkpoint, and
runs epochs of steps fed by a `DevicePrefetcher`, with the JAX loop's
metrics cadence (the first step of each epoch and every 50th), progress bar,
epoch log, optional eval, checkpoint every `checkpoint_save_step` epochs, a
save when SIGTERM or SIGINT arrives, and a final save.

Two injection points stand where the JAX loop draws from its PRNG: `models`,
the initial (G, D, SpecSeg), and `draws`, called once a step as
draws(step, views_shape) -> train.step.Draws, with the step counter before
the step. By default the draws come from one torch.Generator on the device,
seeded from (seed, the steps the run starts from), so a resumed run's draws
depend on where it resumes, as `fold_in(rng, steps_done)` makes them in JAX.

Under a process group (`torchrun`, parallel/mesh.py) every rank runs this
loop on `cuda:LOCAL_RANK` with `cfg.mesh.data_parallel` x
`cfg.mesh.model_parallel` equal to the world size (data_parallel -1 means
what the model axis leaves): the same seeded models, broadcast from rank 0
after the restore, then cut to the rank's slices over the model axis
(`train.state.shard_state`, as the JAX loop places its state after the
restore); the block of every global batch of its data index
(`data.pipeline.rank_feed`); the global batch's draws, seeded alike on
every rank and cut to that block (`Draws.shard`); the step's gradient
averages. Rank 0 writes the summaries, the metrics jsonl and the
checkpoints (which every rank of a model row helps gather whole); the eval
runs on rank 0, or when G is cut on the ranks of rank 0's model row, whose
collectives it joins; the ranks agree on a
preemption signal at every step (`agree_any`), so all stop at the same step
and none is left waiting in a collective. On a spatial layout
(`cfg.mesh.spatial_sharding`, parallel/spatial.py) nothing is cut: each
rank of a model row feeds its band of rows of its data index's block
(`rank_feed`'s band) and takes its rows of the draws (`Draws.rows`); the
eval runs on rank 0 with G whole.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from shmgan_tpu_torch.checkpoint import CheckpointManager, load_specseg_weights
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.convert import flax_tree, load_flax
from shmgan_tpu_torch.data.loader import PolarimetricDataset
from shmgan_tpu_torch.data.pipeline import rank_feed
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.parallel.mesh import (agree_any, is_main, local_device, rank_layout,
                                            training_mesh)
from shmgan_tpu_torch.train.state import (TrainState, broadcast_state, create_train_state,
                                          is_model_sharded, param_count, shard_state)
from shmgan_tpu_torch.train.step import Draws, make_train_step, sample_draws
from shmgan_tpu_torch.utils.logging import MetricsWriter, StepTimer, progress_bar
from shmgan_tpu_torch.utils.viz import write_model_summaries

DrawSource = Callable[[int, Sequence[int]], Draws]


class PreemptionGuard:
    """SIGTERM and SIGINT set a flag; the loop checkpoints and stops at the
    next step boundary, so a preempted run loses at most one step, and
    auto-resume picks it up."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not the main thread
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def draw_source(cfg: Config, device, steps_done: int = 0, rank_index: int = 0,
                world: int = 1, band_index: int = 0, bands: int = 1) -> DrawSource:
    """`sample_draws` on one torch.Generator on `device`, seeded from
    (cfg.train.seed, steps_done): the global batch's draws (world times the
    views' batch, `bands` times their rows), cut to rank `rank_index`'s
    block and band `band_index`'s rows."""
    seed = int(np.random.SeedSequence([cfg.train.seed, steps_done]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(step: int, shape: Sequence[int]) -> Draws:
        v, b, h, w, _ = shape
        return sample_draws(cfg, gen, v, b * world, h * bands, w).shard(
            rank_index, world).rows(band_index, bands)

    return draw


def _initial_models(cfg: Config, device, log) -> Tuple:
    models = build_models(cfg, device=device, seed=cfg.train.seed)
    if os.path.exists(cfg.eval.specseg_weights):
        ss = load_specseg_weights(cfg.eval.specseg_weights,
                                  base_filters=cfg.model.specseg_base_filters,
                                  image_size=cfg.model.image_size)
        load_flax(models[2], ss["params"], ss.get("batch_stats"))
        log(f"[specseg] loaded frozen weights from {cfg.eval.specseg_weights}")
    else:
        log(f"[specseg] {cfg.eval.specseg_weights} not found — random frozen init "
            "(the reference's pre-trained h5 is a separate artifact)")
    return models


def train(cfg: Config, dataset: Optional[PolarimetricDataset] = None,
          max_steps: Optional[int] = None, verbose: bool = True,
          handle_preemption: bool = True, eval_inputs=None, eval_targets=None,
          eval_every_epochs: int = 10, *, device="cuda", models: Optional[Tuple] = None,
          draws: Optional[DrawSource] = None) -> TrainState:
    """Run training on `device` and return the final state; max_steps trims
    the run. eval_inputs / eval_targets: held-out (N, H, W, 3) RGB pairs
    (specular input, diffuse truth) evaluated every `eval_every_epochs`
    epochs on the calibrated inference output, written under eval/*.
    models: the initial (G, D, SpecSeg) (default: build_models from
    cfg.train.seed); draws: the step's random draws (default: draw_source)."""
    mesh = training_mesh(cfg)
    device = local_device(torch_device(device))
    verbose = verbose and is_main()
    log = (lambda *a: print(*a, flush=True)) if verbose else (lambda *a: None)
    guard = PreemptionGuard(install=handle_preemption)
    try:
        return _train(cfg, dataset, max_steps, verbose, guard, eval_inputs, eval_targets,
                      eval_every_epochs, device, models, draws, log, mesh)
    finally:
        guard.restore()


def _train(cfg, dataset, max_steps, verbose, guard, eval_inputs, eval_targets,
           eval_every_epochs, device, models, draws, log, mesh) -> TrainState:
    tr = cfg.train
    if dataset is None:
        dataset = PolarimetricDataset(cfg.data, cfg.model.image_size, tr.batch_size)
    log(f"[data] {len(dataset)} aligned 5-view images, "
        f"{dataset.batches_per_epoch} batches/epoch")

    if models is None:
        models = _initial_models(cfg, device, log)
    state = create_train_state(cfg, tuple(m.to(device) for m in models))
    g_tree, d_tree = flax_tree(state.gen)[0], flax_tree(state.disc)[0]
    ss_params, ss_stats = flax_tree(state.specseg)
    ss_tree = {"batch_stats": ss_stats, "params": ss_params}
    log(f"[models] G params: {param_count(g_tree):,}  D params: {param_count(d_tree):,}  "
        f"SpecSeg params: {param_count(ss_tree):,} (frozen)")
    main = is_main()
    if main:
        write_model_summaries(g_tree, d_tree, ss_tree,
                              out_dir=os.path.join(tr.model_save_dir, "summaries"))

    ckpt = CheckpointManager(tr.checkpoint_save_dir, max_to_keep=tr.checkpoint_max_to_keep)
    start_epoch = steps_done = 0
    if tr.auto_resume and not tr.delete_old_checkpoints:
        if ckpt.restore(state) is not None:
            steps_done = state.step
            start_epoch = steps_done // max(dataset.batches_per_epoch, 1)
            log(f"[ckpt] restored step {steps_done} (epoch {start_epoch})")
    broadcast_state(state)
    layout = rank_layout(mesh)
    shard_state(state, layout, cfg.model.image_size, cfg.mesh.tp_min_channels)
    band_index, bands = ((layout.model_index, layout.model_parallel) if layout.spatial
                         else (0, 1))
    if draws is None:
        draws = draw_source(cfg, device, steps_done, layout.data_index, layout.data_parallel,
                            band_index, bands)
    step_fn = make_train_step(cfg)

    writer = MetricsWriter(tr.log_dir) if main else None
    run_eval = None
    if (main or (is_model_sharded(state) and layout.data_index == 0)) \
            and eval_inputs is not None and eval_targets is not None:
        run_eval = _evaluator(cfg, device, writer, log, eval_inputs, eval_targets)

    epoch_timer = StepTimer()
    total_steps = 0
    for epoch in range(start_epoch, tr.num_epochs):
        # every epoch in the same order as the JAX loop's: file order, or a
        # shuffle derived from (seed, epoch)
        shuffle_seed = (tr.seed * 100003 + epoch) if tr.shuffle else None
        feed = rank_feed(dataset, shuffle_seed=shuffle_seed, device=device,
                         depth=cfg.data.prefetch, process_index=layout.data_index,
                         process_count=layout.data_parallel, band_index=band_index,
                         band_count=bands)
        t_epoch = time.perf_counter()
        try:
            for batch_idx, views in enumerate(feed):
                state, metrics = step_fn(state, views, draws(state.step, views.shape), epoch)
                total_steps += 1
                epoch_timer.tick(tr.batch_size)
                # float() of a device value waits for the device: at this
                # cadence only
                if main and (total_steps % 50 == 0 or batch_idx == 0):
                    writer.write(state.step, metrics)
                if verbose:
                    progress_bar(batch_idx + 1, dataset.batches_per_epoch,
                                 prefix=f"epoch {epoch} ")
                if max_steps is not None and total_steps >= max_steps:
                    break
                if agree_any(guard.requested):
                    break
        finally:
            feed.close()

        if agree_any(guard.requested):
            log("\n[preempt] signal received — checkpointing and exiting")
            log(f"[ckpt] saved step {ckpt.save(state)}")
            break
        if (epoch + 1) % tr.log_step == 0:
            log(f"\n[epoch {epoch + 1}] {time.perf_counter() - t_epoch:.1f}s  "
                f"{epoch_timer.images_per_sec:.2f} img/s")
        if run_eval is not None and (epoch + 1) % eval_every_epochs == 0:
            run_eval(state, epoch + 1)
        if (epoch + 1) % tr.checkpoint_save_step == 0:
            log(f"[ckpt] saved step {ckpt.save(state)}")
        if max_steps is not None and total_steps >= max_steps:
            break

    ckpt.save(state)
    ckpt.close()
    if writer is not None:
        writer.close()
    return state


def _evaluator(cfg, device, writer, log, eval_inputs, eval_targets):
    from shmgan_tpu_torch.eval.metrics import evaluate_pair
    from shmgan_tpu_torch.infer import make_infer_fn

    infer_fn = make_infer_fn(cfg, outputs=("gen_rgb_calibrated",))
    inputs = torch.as_tensor(np.asarray(eval_inputs, np.float32), device=device)
    targets = torch.as_tensor(np.asarray(eval_targets, np.float32), device=device)

    def run_eval(state: TrainState, epoch: int) -> None:
        out = infer_fn(state.gen, state.specseg, inputs)
        means = {k: float(v.mean()) for k, v in
                 evaluate_pair(out["gen_rgb_calibrated"], targets).items()}
        if writer is None:  # a rank that only joins a cut G's collectives
            return
        writer.write(state.step, means, prefix="eval/")
        log(f"[eval epoch {epoch}] " + "  ".join(f"{k}={v:.4f}" for k, v in means.items()))

    return run_eval
