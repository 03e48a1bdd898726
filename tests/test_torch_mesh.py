"""The port's data-parallel layout and its collectives' edges, on the CPU:
`make_mesh` against the JAX package's `make_mesh` on the conftest's 8
virtual devices (the same shape and device order, the same refusal of a
layout larger than the devices), the refusals of what the port does not run
(a layout of more than one rank without a process group, which says how to
launch; a degree other than the world size), a model axis and spatial
sharding over it accepted as JAX lays them out, `Draws.shard` and
`local_batch` against slices made by hand, the collectives without a group
and in a one-rank gloo group, and `device_report`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from shmgan_tpu_torch import Config, cli, quality_train
from shmgan_tpu_torch.data.pipeline import local_batch
from shmgan_tpu_torch.parallel import mesh
from shmgan_tpu_torch.train.loop import train
from shmgan_tpu_torch.train.step import Draws
from shmgan_tpu_torch.utils.device import device_report, print_device_report


def _configs(dp, mp=1):
    jcfg, cfg = JConfig(), Config()
    jcfg.mesh = dataclasses.replace(jcfg.mesh, data_parallel=dp, model_parallel=mp)
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = dp, mp
    return jcfg, cfg


@pytest.mark.parametrize("dp", [-1, 1, 2, 4, 8])
def test_make_mesh_matches_jax(dp):
    jcfg, cfg = _configs(dp)
    want = j_make_mesh(jcfg)
    got = mesh.make_mesh(cfg, len(jax.devices()))
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert got.shape == want.devices.shape
    np.testing.assert_array_equal(got.devices, ids)


@pytest.mark.parametrize("dp,mp", [(16, 1), (4, 4)])
def test_too_large_a_mesh_raises_as_jax(dp, mp):
    jcfg, cfg = _configs(dp, mp)
    with pytest.raises(ValueError) as want:
        j_make_mesh(jcfg)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(cfg, 8)
    assert str(got.value) == str(want.value)


def test_model_axis_is_refused():
    """A model axis is accepted and laid out as JAX's (rank i * M + j at
    data index i, model index j), with spatial sharding too; spatial
    sharding over a model axis of one rank is the plain layout, as in JAX;
    without a process group a spatial mesh says how to launch."""
    for dp, mp in ((-1, 2), (2, 4), (1, 2)):
        for spatial in (False, True):
            jcfg, cfg = _configs(dp, mp)
            jcfg.mesh = dataclasses.replace(jcfg.mesh, spatial_sharding=spatial)
            cfg.mesh.spatial_sharding = spatial
            want = np.vectorize(lambda d: d.id)(j_make_mesh(jcfg).devices)
            got = mesh.make_mesh(cfg, 8)
            assert got.shape == want.shape and got.spatial == spatial
            np.testing.assert_array_equal(got.devices, want)
    _, cfg = _configs(4, 1)
    cfg.mesh.spatial_sharding = True
    assert mesh.make_mesh(cfg, 8) == mesh.Mesh(4, 1)
    _, cfg = _configs(-1, 2)
    cfg.mesh.spatial_sharding = True
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        mesh.training_mesh(cfg)


def test_data_parallel_without_a_launcher_raises(tmp_path, monkeypatch):
    """--data_parallel 2, or a model axis, with no process group says how to
    launch, from the CLI, the loop and the flagship trainer, and never runs
    on one device."""
    monkeypatch.chdir(tmp_path)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    _, cfg = _configs(2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        mesh.training_mesh(cfg)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        cli.main(["--mode", "train", "--data_parallel", "2"], device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        train(cfg, device="cpu", verbose=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        quality_train.main(["--cpu", "--phase", "gan", "--data_parallel", "2",
                            "--out", str(tmp_path / "never")])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 .*--model_parallel 2"):
        cli.main(["--mode", "export", "--model_parallel", "2"], device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4 .*--model_parallel 2"):
        train(_configs(2, 2)[1], device="cpu", verbose=False)
    assert not (tmp_path / "never").exists() and not (tmp_path / "models").exists()


def test_one_rank_group(monkeypatch):
    """In a one-rank gloo group: data_parallel -1 and 1 are the world size,
    2 is not, nor is a model axis of 2; the collectives keep every value
    (sum over one rank, / 1), agree_any reads the flag and agree_max the
    value; the rank's layout is (0, 0)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    assert mesh.maybe_initialize_distributed("gloo")
    try:
        assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)
        for dp in (-1, 1):
            assert mesh.training_mesh(_configs(dp)[1]).shape == (1, 1)
        with pytest.raises(ValueError, match="must be WORLD_SIZE"):
            mesh.training_mesh(_configs(2)[1])
        with pytest.raises(ValueError, match="must be WORLD_SIZE"):
            mesh.training_mesh(_configs(-1, 2)[1])
        layout = mesh.rank_layout(mesh.training_mesh(_configs(1)[1]))
        assert (layout.data_index, layout.model_index, layout.data_parallel) == (0, 0, 1)
        floats = [torch.arange(6.0).view(2, 3), torch.tensor(2.5)]
        tensors = floats + [torch.arange(3)]
        before = [t.clone() for t in tensors]
        mesh.all_reduce_mean_(floats)
        mesh.broadcast_(tensors)
        assert all(torch.equal(a, b) for a, b in zip(tensors, before))
        assert mesh.agree_any(True) and not mesh.agree_any(False)
        assert mesh.agree_max(2.5) == 2.5
        mesh.barrier()
    finally:
        mesh.shutdown_distributed()
    assert mesh.world_size() == 1


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collectives_without_a_group():
    t = torch.ones(3)
    mesh.all_reduce_mean_([t])
    mesh.broadcast_([t])
    mesh.barrier()
    assert torch.equal(t, torch.ones(3)) and mesh.agree_any(True) and not mesh.agree_any(False)
    assert mesh.agree_max(2.5) == 2.5
    assert mesh.local_device("cuda") == torch.device("cuda")


@pytest.mark.parametrize("per_sample", [False, True])
def test_draws_shard(per_sample):
    """Rank r of 2 at global batch 4: rows [2r, 2r + 2) of a per-sample drop,
    and of each half of the [generated; ED] noise and keep stacks."""
    g = torch.Generator().manual_seed(0)
    drop = torch.rand((4 if per_sample else 1, 5), generator=g)
    noise, keep = torch.randn((8, 3, 4, 4), generator=g), torch.rand((8, 2, 1, 1), generator=g)
    d = Draws(flip=torch.tensor(True), t=torch.tensor(1.1), drop=drop, noise=noise, keep=keep)
    assert d.shard(0, 1) is d
    for r in range(2):
        s = d.shard(r, 2)
        assert s.flip is d.flip and s.t is d.t
        rows = [2 * r, 2 * r + 1]
        assert torch.equal(s.drop, drop[rows] if per_sample else drop)
        assert torch.equal(s.noise, noise[rows + [4 + i for i in rows]])
        assert torch.equal(s.keep, keep[rows + [4 + i for i in rows]])


def test_local_batch():
    views = np.arange(5 * 6 * 2).reshape(5, 6, 2)
    parts = [local_batch(views, r, 3) for r in range(3)]
    assert all(p.shape == (5, 2, 2) for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), views)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 processes"):
        local_batch(views, 0, 4)


def test_device_report(capsys):
    rep = device_report()
    assert rep["process_count"] == 1 and rep["process_index"] == 0
    assert len(rep["devices"]) == rep["device_count"]
    if not torch.cuda.is_available():
        assert rep["backend"] == "cpu" and rep["devices"] == []
    print_device_report()
    assert "[devices] backend=" in capsys.readouterr().out
