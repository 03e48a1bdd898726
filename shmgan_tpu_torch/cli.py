"""The port's command line: the counterpart of shmgan_tpu/cli.py, with the
same flags (config.Config.from_args). Serving runs; the other modes raise,
naming the ROADMAP item that ports them.

    python -m shmgan_tpu_torch.cli --mode serve \
        --serve_weights_bundle artifacts/shmgan_infer_256.msgpack \
        --serve_port 8000 --serve_batch_size 8 --serve_batch_window_ms 20
    python -m shmgan_tpu_torch.cli --mode serve --serve_weights_bundle <bundle> \
        --serve_watch_dir in/ --result_dir out/          # folder-watch daemon

It serves on the CUDA card; `device="cpu"` in `main` (or `run_serve`) serves
on the CPU, through the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from shmgan_tpu_torch.checkpoint import load_inference_bundle, model_config
from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import load_inference_weights
from shmgan_tpu_torch.models import build_models

_NOT_PORTED = {
    "train": "the train loop with its checkpoints (train/loop.py) is ROADMAP Queue 1 "
             "item 10",
    "test": "test mode needs eval/metrics.py and the Lab/deltaE colour ops, ROADMAP "
            "Queue 1 items 6 and 8",
    "export": "export reads a train checkpoint, ROADMAP Queue 1 item 10 (the bundle "
              "writer is checkpoint.export_inference_bundle)",
    "bench": "the port's benchmark is ROADMAP Queue 1 item 2",
}


def serving_models(cfg: Config, device: str = "cuda"
                   ) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(G, SpecSeg) on `device` with the weights of --serve_weights_bundle,
    whose header overrides cfg.model. Without a bundle the JAX package
    restores a train checkpoint, which the port cannot read yet: that
    raises, rather than serve random weights."""
    if not cfg.serve.weights_bundle:
        raise NotImplementedError(
            "serving without --serve_weights_bundle restores a train checkpoint; the port "
            "has no reader for one yet (ROADMAP Queue 1 item 10)")
    g_params, specseg_vars, header = load_inference_bundle(cfg.serve.weights_bundle)
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, specseg_vars)
    print(f"[serve] loaded bundle step {header['step']} ({cfg.serve.weights_bundle}); "
          f"model config from header: {header}", flush=True)
    return gen.to(device), specseg.to(device)


def run_serve(cfg: Config, device: str = "cuda") -> None:
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


def main(argv: Optional[list] = None, device: str = "cuda") -> None:
    cfg = Config.from_args(argv)
    if cfg.mode != "serve":
        raise NotImplementedError(f"--mode {cfg.mode} is not ported yet: "
                                  f"{_NOT_PORTED[cfg.mode]}")
    run_serve(cfg, device)


if __name__ == "__main__":
    main()
