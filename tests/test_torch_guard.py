"""The port and chip_smoke.py stay free of JAX and of what the card's machine
lacks: no import of jax, flax, optax, orbax, msgpack, PIL or shmgan_tpu, by
reading the sources and by running the port where those modules cannot be
imported."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "PIL", "shmgan_tpu")


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
        sys.meta_path.insert(0, Block())

        import numpy as np
        import chip_smoke  # noqa: F401  (imports without running)
        from shmgan_tpu_torch import Config
        from shmgan_tpu_torch.models import build_models
        from shmgan_tpu_torch.serve import BatchInferenceEngine

        cfg = Config()
        cfg.model.filter_size, cfg.model.specseg_base_filters = 8, 4
        gen, specseg = build_models(cfg, device="cpu", seed=0)
        out = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu"
                                   ).process_images(np.full((1, 32, 32, 3), 0.5, np.float32))
        assert np.isfinite(out["gen_rgb_calibrated"]).all()
        print("OK", sorted(m for m in sys.modules if m.split(".")[0] in BANNED))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []", proc.stdout
