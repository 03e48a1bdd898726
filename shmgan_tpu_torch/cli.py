"""The port's command line: the counterpart of shmgan_tpu/cli.py, with the
same flags (config.Config.from_args).

    python -m shmgan_tpu_torch.cli --mode train --data_dir <polar-root> \
        --batch_size 8 --num_epochs 200 --checkpoint_save_dir ckpt/
    python -m shmgan_tpu_torch.cli --mode test --test_dir <imgs> \
        [--calc_metrics true --diffuse_dir <truth>] [--native_resolution true]
    python -m shmgan_tpu_torch.cli --mode export --model_save_dir out/ \
        [--export_dtype float16]                    # out/shmgan_infer.msgpack
    python -m shmgan_tpu_torch.cli --mode serve \
        [--serve_weights_bundle artifacts/shmgan_infer_256.msgpack] \
        --serve_port 8000 --serve_batch_size 8 --serve_batch_window_ms 20
    python -m shmgan_tpu_torch.cli --mode serve --serve_watch_dir in/ --result_dir out/

test, export and serve without a bundle restore the train checkpoint under
--checkpoint_save_dir (--checkpoint_step, default the latest), with the EMA
generator when it has one and --use_ema is on. Everything runs on the CUDA
card; `device="cpu"` in `main` (or any run_*) runs on the CPU, through the
kernels' plain versions. --mode bench is not ported (ROADMAP Queue 1 item 2).

Data-parallel and tensor-parallel training run one process a card under
`torchrun`:

    torchrun --nproc_per_node 4 -m shmgan_tpu_torch.cli --mode train \
        --data_parallel 4 --batch_size 8 --data_dir <polar-root>
    torchrun --nproc_per_node 4 -m shmgan_tpu_torch.cli --mode train \
        --data_parallel 2 --model_parallel 2 --batch_size 8 --data_dir <polar-root>

--data_parallel times --model_parallel must be the number of processes
(--data_parallel -1, the default, means what the model axis leaves); a
layout of more than one process without a launcher raises, rather than run
on one card. --model_parallel M splits the wide conv kernels' output
channels over M ranks (parallel/tp.py), as the JAX package's mesh does;
checkpoints hold the whole state whatever the mesh. The process group is
NCCL on the card, gloo on the CPU. Under a launcher, test and export run on
rank 0 while the others wait. Serving data parallelism is one process over
--data_parallel cards (serve.BatchInferenceEngine); serving ignores
--model_parallel, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from shmgan_tpu_torch.checkpoint import (CheckpointManager, load_inference_bundle,
                                         load_specseg_weights, model_config,
                                         specseg_in_channels_of)
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.convert import load_flax, load_inference_weights
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.parallel.mesh import (barrier, is_main, maybe_initialize_distributed,
                                            rank, shutdown_distributed, training_mesh,
                                            world_size)
from shmgan_tpu_torch.train.state import TrainState, create_train_state


def run_train(cfg: Config, device="cuda") -> None:
    from shmgan_tpu_torch.train.loop import train

    if is_main():
        print(cfg.describe(), flush=True)
    train(cfg, device=device)
    if is_main():
        print(" [*] Training finished!", flush=True)


def _restored_state(cfg: Config, device="cuda") -> TrainState:
    """The train state of --checkpoint_step (default the latest) under
    --checkpoint_save_dir, on `device`; with --use_ema and an EMA in the
    checkpoint, G holds the EMA weights. Without a checkpoint: random
    weights from the seed, with a warning."""
    device = torch_device(device)
    specseg_vars = None
    if os.path.exists(cfg.eval.specseg_weights):
        specseg_vars = load_specseg_weights(cfg.eval.specseg_weights,
                                            base_filters=cfg.model.specseg_base_filters,
                                            image_size=cfg.model.image_size)
        in_ch = specseg_in_channels_of(specseg_vars)
        if in_ch != cfg.model.specseg_in_channels:
            cfg.model = dataclasses.replace(cfg.model, specseg_in_channels=in_ch)
    models = build_models(cfg, device=device, seed=cfg.train.seed)
    if specseg_vars is not None:
        load_flax(models[2], specseg_vars["params"], specseg_vars.get("batch_stats"))
    state = create_train_state(cfg, models)
    ckpt = CheckpointManager(cfg.train.checkpoint_save_dir,
                             max_to_keep=cfg.train.checkpoint_max_to_keep)
    restored = ckpt.restore(state, step=cfg.eval.checkpoint_step or None,
                            include_ema=cfg.eval.use_ema)
    if restored is None:
        print("[ckpt] WARNING: no checkpoint found — using random weights", flush=True)
    elif cfg.eval.use_ema and state.ema_g is not None:
        # deploy the averaged weights an EMA run is evaluated with
        with torch.no_grad():
            for name, p in state.gen.named_parameters():
                p.copy_(state.ema_g[name])
        state.ema_g = None
        print(f"[ckpt] restored step {state.step} (EMA generator)", flush=True)
    else:
        print(f"[ckpt] restored step {state.step}", flush=True)
    return state


def run_test(cfg: Config, device="cuda") -> None:
    """Single-RGB inference over --test_dir: result_NNNNN.png (calibrated),
    _mask.png and _composited.png under --result_dir; with --calc_metrics,
    each result against --diffuse_dir's image of the same rank, a report and
    metrics.jsonl. --native_resolution infers each photo at its own size."""
    from shmgan_tpu_torch.data.loader import SingleFolderDataset
    from shmgan_tpu_torch.eval.metrics import MetricAccumulator, evaluate_pair
    from shmgan_tpu_torch.infer import make_infer_fn, make_native_infer_fn
    from shmgan_tpu_torch.serve import png_bytes

    device = torch_device(device)
    print(cfg.describe(), flush=True)
    state = _restored_state(cfg, device)
    outputs = ("gen_rgb_calibrated", "mask", "gen_rgb_composited")
    if cfg.eval.native_resolution:
        native = make_native_infer_fn(cfg, outputs=outputs)
        size = None

        def infer(rgb):
            return {k: torch.from_numpy(v).to(device)
                    for k, v in native(state.gen, state.specseg, rgb).items()}
    else:
        fixed = make_infer_fn(cfg, outputs=outputs)
        size = cfg.model.image_size

        def infer(rgb):
            return fixed(state.gen, state.specseg, torch.from_numpy(rgb).to(device))

    batch = cfg.train.batch_size
    test_ds = SingleFolderDataset(cfg.data.test_dir, size, batch_size=batch)
    diffuse_iter = None
    if cfg.eval.calc_metrics:
        diffuse_iter = iter(SingleFolderDataset(cfg.data.diffuse_dir, size, batch_size=batch))
    os.makedirs(cfg.train.result_dir, exist_ok=True)
    acc = MetricAccumulator()
    for i, rgb in enumerate(test_ds):
        t0 = time.perf_counter()
        out = infer(rgb)
        host = {k: v.float().cpu().numpy() for k, v in out.items()}
        wall = time.perf_counter() - t0
        for j in range(host["gen_rgb_calibrated"].shape[0]):
            stem = os.path.join(cfg.train.result_dir, f"result_{i * batch + j:05d}")
            for suffix, img in (("", host["gen_rgb_calibrated"][j]),
                                ("_mask", host["mask"][j, ..., 0]),
                                ("_composited", host["gen_rgb_composited"][j])):
                with open(f"{stem}{suffix}.png", "wb") as f:
                    f.write(png_bytes(img))
        if diffuse_iter is not None:
            acc.add(evaluate_pair(out["gen_rgb_calibrated"], next(diffuse_iter)),
                    wall_time=wall)
    if cfg.eval.calc_metrics and acc.rows:
        print("\n --- CALCULATED METRICS --- ")
        print(acc.report(), flush=True)
        acc.dump_jsonl(os.path.join(cfg.train.result_dir, "metrics.jsonl"))


def run_export(cfg: Config, device="cuda") -> None:
    """The serving bundle (G and SpecSeg, no optimizer state) of the
    restored checkpoint: <model_save_dir>/shmgan_infer.msgpack and its .json."""
    from shmgan_tpu_torch.checkpoint import export_inference_bundle

    state = _restored_state(cfg, device)
    path = os.path.join(cfg.train.model_save_dir, "shmgan_infer.msgpack")
    export_inference_bundle(state.gen, state.specseg, cfg, path, step=state.step,
                            store_dtype=cfg.eval.export_dtype or None)
    print(f"[export] wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, step {state.step})",
          flush=True)


def serving_models(cfg: Config, device="cuda") -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(G, SpecSeg) on `device`: the weights of --serve_weights_bundle, whose
    header overrides cfg.model, or else of the restored train checkpoint."""
    if not cfg.serve.weights_bundle:
        state = _restored_state(cfg, device)
        return state.gen, state.specseg
    g_params, specseg_vars, header = load_inference_bundle(cfg.serve.weights_bundle)
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, specseg_vars)
    print(f"[serve] loaded bundle step {header['step']} ({cfg.serve.weights_bundle}); "
          f"model config from header: {header}", flush=True)
    return gen.to(device), specseg.to(device)


def run_serve(cfg: Config, device="cuda") -> None:
    """The HTTP server (default), or the folder-watch daemon with
    --serve_watch_dir, writing into --result_dir."""
    gen, specseg = serving_models(cfg, device)
    if cfg.serve.watch_dir:
        from shmgan_tpu_torch.serve import BatchInferenceEngine

        eng = BatchInferenceEngine(cfg, gen, specseg, batch_size=cfg.serve.batch_size,
                                   native_resolution=cfg.eval.native_resolution,
                                   outputs=("gen_rgb_calibrated", "mask"),
                                   data_parallel=cfg.mesh.data_parallel, device=device)
        print(f"[serve] watching {cfg.serve.watch_dir} -> {cfg.train.result_dir}", flush=True)
        eng.watch_folder(cfg.serve.watch_dir, cfg.train.result_dir)
    else:
        from shmgan_tpu_torch.serve_http import serve_forever

        serve_forever(cfg, gen, specseg, host=cfg.serve.host, port=cfg.serve.port,
                      batch_size=cfg.serve.batch_size,
                      batch_window_ms=cfg.serve.batch_window_ms,
                      warm_sizes=cfg.serve.warm_sizes, device=device)


def main(argv: Optional[list] = None, device="cuda") -> None:
    cfg = Config.from_args(argv)
    if cfg.mode == "bench":
        raise NotImplementedError("--mode bench is not ported yet: the port's benchmark is "
                                  "ROADMAP Queue 1 item 2")
    if cfg.mode == "serve":
        run_serve(cfg, device)
        return
    # train, test and export join the launcher's process group, if any
    joined = not dist.is_initialized() and maybe_initialize_distributed(
        "gloo" if torch.device(device).type == "cpu" else "nccl")
    if joined:
        print(f"[dist] rank {rank()} of {world_size()}, backend {dist.get_backend()}",
              flush=True)
    try:
        training_mesh(cfg)
        if cfg.mode == "train":
            run_train(cfg, device)
        elif is_main():
            {"test": run_test, "export": run_export}[cfg.mode](cfg, device)
        barrier()
    finally:
        if joined:
            shutdown_distributed()


if __name__ == "__main__":
    main()
