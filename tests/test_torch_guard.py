"""The port and chip_smoke.py stay free of JAX and of what the card's machine
lacks: no import of jax, flax, optax, orbax, msgpack, PIL, matplotlib, h5py,
zstandard, tabulate, tensorboard or shmgan_tpu, by reading the sources and by
running the port (serving, a bundle and a PNG read and written, one train
step, the command line's train, export and test modes on a tiny tree, the
data-parallel layout, device report and a two-shard engine, two SpecSeg steps
of the flagship trainer's phase A, two GAN steps of its phase B on the DR
curriculum with an eval, galleries and the best bundle, the reference's Keras
h5 read and an hdf5 dump written, the plots and the profiling hooks, a PPM
tree through the host batch decoder) where those modules cannot be imported.
The host batch decoder is the port's own: the library a native batch loads
is built from shmgan_tpu_torch/csrc/ into shmgan_tpu_torch/_build/, and no
source of the port or chip_smoke.py names the JAX package's native/ library,
its source or its Makefile outside a docstring.

orbax_to_torch.py, the Orbax converter, is the one file outside tests/ that
imports both packages, and nothing of the port or chip_smoke.py reaches it."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "PIL", "matplotlib", "h5py",
          "zstandard", "zstd", "tabulate", "tensorboard", "shmgan_tpu")
CONVERTER = "orbax_to_torch.py"
# what is not the repo's own source: build outputs, proof trees, chip runs
NOT_SOURCE = {".git", "_proof", "chiprun_out", "tests", "__pycache__", "_build"}


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "shmgan_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_banned_import_in_sources():
    found = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in BANNED:
                found.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not found, found


def _code_strings(path):
    """The string constants of a source, docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


def test_no_source_reaches_the_jax_native_library():
    found = []
    for path in _port_sources():
        for text in _code_strings(path):
            if "libshmgan_native" in text or "native/" in text or "/loader.cc" in text \
                    or text in ("loader.cc", "Makefile"):
                found.append(f"{os.path.relpath(path, REPO)}: {text[:60]!r}")
    assert not found, found


def test_the_converter_is_the_one_bridge():
    """Outside tests/, only the converter imports both packages; the port
    and chip_smoke.py never import it."""
    both = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if d not in NOT_SOURCE]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                tops = {m.split(".")[0] for m in _imported_modules(path)}
                if {"shmgan_tpu", "shmgan_tpu_torch"} <= tops:
                    both.append(os.path.relpath(path, REPO))
    assert both == [CONVERTER]
    reach = [os.path.relpath(p, REPO) for p in _port_sources()
             if CONVERTER[:-3] in {m.split(".")[0] for m in _imported_modules(p)}]
    assert not reach


def test_port_runs_with_banned_modules_blocked():
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        BANNED = {BANNED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BANNED:
                    raise ImportError("blocked: " + name)

        for m in list(sys.modules):
            if m.split(".")[0] in BANNED:
                del sys.modules[m]
        # torch.profiler loads torch._dynamo, which asks importlib whether
        # optional modules (tabulate among them) exist; it imports none, as
        # the check of sys.modules at the end shows
        import torch._dynamo  # noqa: F401
        sys.meta_path.insert(0, Block())

        import numpy as np
        import chip_smoke  # noqa: F401  (imports without running)
        from shmgan_tpu_torch import Config
        from shmgan_tpu_torch.models import build_models
        from shmgan_tpu_torch.serve import BatchInferenceEngine

        cfg = Config()
        cfg.model.filter_size, cfg.model.specseg_base_filters = 8, 4
        gen, _, specseg = build_models(cfg, device="cpu", seed=0)
        out = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu"
                                   ).process_images(np.full((1, 32, 32, 3), 0.5, np.float32))
        assert np.isfinite(out["gen_rgb_calibrated"]).all()

        # data parallelism: the layout, the device report, a two-shard engine
        from shmgan_tpu_torch.parallel.mesh import make_mesh
        from shmgan_tpu_torch.utils.device import device_report
        assert make_mesh(cfg, 4).shape == (4, 1) and device_report()["process_count"] == 1
        dp = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, data_parallel=2,
                                  device="cpu").process_images(np.full((1, 32, 32, 3), 0.5,
                                                                       np.float32))
        assert np.array_equal(dp["gen_rgb_calibrated"], out["gen_rgb_calibrated"])

        # serving's own I/O: a bundle, a PNG, the HTTP front end and the CLI
        import shmgan_tpu_torch.cli  # noqa: F401
        import shmgan_tpu_torch.serve_http  # noqa: F401
        from shmgan_tpu_torch.checkpoint import load_inference_bundle
        from shmgan_tpu_torch.data.codecs import decode, encode_png

        _, _, header = load_inference_bundle("artifacts/shmgan_infer.msgpack")
        assert header["image_size"] == 128
        img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
        assert (decode(encode_png(img)) == img).all()

        import torch
        import shmgan_tpu_torch.profile_train  # noqa: F401
        torch.set_num_threads(1)  # the suite's other workers hold the cores
        from shmgan_tpu_torch.train.state import create_train_state
        from shmgan_tpu_torch.train.step import make_train_step, sample_draws

        cfg.model.image_size = 64
        state = create_train_state(cfg, build_models(cfg, device="cpu", seed=0))
        g = torch.Generator().manual_seed(0)
        state, m = make_train_step(cfg)(state, torch.rand((5, 1, 64, 64, 3), generator=g),
                                        sample_draws(cfg, g, 5, 1, 64, 64), 0)
        assert state.step == 1 and all(torch.isfinite(v).all() for v in m.values())

        # the command line: train two epochs, export, test with metrics
        import os, shutil, tempfile
        from shmgan_tpu_torch import cli
        from shmgan_tpu_torch.data.synthetic import write_fixture_tree

        root = tempfile.mkdtemp()
        write_fixture_tree(os.path.join(root, "tree"), 4, 32)
        common = ["--image_size", "32", "--filter_size", "4", "--batch_size", "2",
                  "--data_dir", os.path.join(root, "tree"),
                  "--checkpoint_save_dir", os.path.join(root, "ckpt"),
                  "--log_dir", os.path.join(root, "logs"),
                  "--model_save_dir", os.path.join(root, "models"),
                  "--result_dir", os.path.join(root, "results")]
        cli.main(["--mode", "train", "--num_epochs", "2", "--checkpoint_save_step", "1"]
                 + common, device="cpu")
        cli.main(["--mode", "export"] + common, device="cpu")
        assert os.path.getsize(os.path.join(root, "models", "shmgan_infer.msgpack")) > 0
        cli.main(["--mode", "test", "--calc_metrics", "true",
                  "--test_dir", os.path.join(root, "tree", "I0"),
                  "--diffuse_dir", os.path.join(root, "tree", "ED")] + common, device="cpu")
        with open(os.path.join(root, "results", "metrics.jsonl")) as f:
            assert len(f.readlines()) == 5

        # a PPM tree through the host batch decoder: the port's own library
        from shmgan_tpu_torch.config import DataConfig
        from shmgan_tpu_torch.data.loader import PolarimetricDataset
        from shmgan_tpu_torch.runtime import build, native_loader

        write_fixture_tree(os.path.join(root, "ppm"), 2, 16, fmt="ppm")
        ds = PolarimetricDataset(DataConfig(data_dir=os.path.join(root, "ppm")),
                                 image_size=8, batch_size=2)
        assert ds.used_native_decode and native_loader.calls == 5
        lib = os.path.realpath(native_loader._lib._name)
        assert lib == str(build.library_path("host_loader")), lib
        assert lib.startswith(os.path.realpath("shmgan_tpu_torch/_build") + os.sep), lib
        assert build.source_path("host_loader") == build.CSRC / "host_loader.cc"
        assert os.path.realpath(build.CSRC) == os.path.realpath("shmgan_tpu_torch/csrc")
        with open("/proc/self/maps") as f:
            mapped = {{line.split()[-1] for line in f if line.rstrip().endswith(".so")}}
        assert lib in mapped
        assert not [m for m in mapped if m.startswith(os.path.realpath("native") + os.sep)]

        # the flagship trainer's phase A: 2 SpecSeg steps on device-made DR scenes
        from shmgan_tpu_torch import quality_train
        summary = quality_train.main(
            ["--cpu", "--phase", "specseg", "--image_size", "32", "--specseg_base_filters",
             "4", "--specseg_batch", "2", "--specseg_steps", "2", "--chunk", "1",
             "--specseg_curriculum", "dr3", "--specseg_in_channels", "2",
             "--out", os.path.join(root, "quality")])
        assert os.path.getsize(summary["specseg"]["weights"]) > 0

        # its phase B on that net: 2 GAN steps (DR views), an eval, galleries, a bundle
        gan = quality_train.main(
            ["--cpu", "--phase", "gan", "--image_size", "32", "--filter_size", "4",
             "--specseg_base_filters", "4", "--specseg_in_channels", "2", "--batch", "2",
             "--gan_steps", "2", "--chunk", "1", "--eval_every", "2", "--eval_n", "2",
             "--fid_draws", "1", "--gan_curriculum", "dr", "--dtype", "float32",
             "--specseg_out", summary["specseg"]["weights"],
             "--out", os.path.join(root, "quality")])["gan"]
        assert [r["step"] for r in gan["history"]] == [2]
        for name in ("best_bundle.msgpack", "sample_best_0.png", "sample_final_1.png"):
            assert os.path.getsize(os.path.join(root, "quality", name)) > 0

        # the reference's Keras h5, the hdf5 dump, the plots, the profiling hooks
        from shmgan_tpu_torch.checkpoint import load_specseg_weights
        from shmgan_tpu_torch.runtime import hdf5
        from shmgan_tpu_torch.utils import profiling, viz

        ss = load_specseg_weights("tests/data/torch_h5/specseg_keras2.h5")
        assert ss["params"]["down0"]["conv0"]["kernel"].shape == (3, 3, 1, 16)
        dump = os.path.join(root, "dump.hdf5")
        viz.save_dataset_hdf5(np.ones((2, 3), np.float32), dump)
        assert hdf5.File(dump)["default"][()].sum() == 6
        assert viz.debug_plot(np.zeros((1, 8, 8, 4))).shape == (20, 20, 3)
        assert viz.plot_single_image(np.zeros((8, 8, 3))).shape == (44, 8, 3)
        with profiling.trace(os.path.join(root, "trace")) as prof:
            with profiling.annotate("guard"):
                torch.ones(2) + 1
        assert os.path.getsize(prof.trace_path) > 0
        try:
            with profiling.debug_mode():
                torch.zeros(1) / 0 * 0
            raise AssertionError("no NaN raised")
        except FloatingPointError:
            pass
        assert torch.cuda.is_available() or not profiling.device_memory_stats()
        shutil.rmtree(root)
        assert "orbax_to_torch" not in sys.modules
        print("OK", sorted(m for m in sys.modules if m.split(".")[0] in BANNED))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []", proc.stdout
