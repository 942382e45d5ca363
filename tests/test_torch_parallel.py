"""The port's data-parallel slice (ppn_tpu_torch/parallel/, the global
BatchNorm statistics, the gradient all-reduce, the Trainer's mesh) on the
CPU: the mesh helpers and the rules of ``multihost.initialize`` (the cases
of tests/test_parallel.py:59-125), then a real 2-process gloo world
(tests/torch_dist_worker.py, spawned once for the module) against one
process on the joined batch and against the JAX package's 2-device mesh.

Tolerances: one f32 step of two ranks against one process within rel 1e-5
on the loss terms and 1e-5·max|p| on every parameter and running
statistic (the sums run in another order: two halves, then the
all-reduce); the bf16 loss against the JAX package's 2-device mesh within
rel 2e-3, tests/test_parallel.py:155's tolerance for bf16 convs reduced
in other orders.
"""

import dataclasses
import os
import socket
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.parallel import make_mesh as jax_make_mesh
from ppn_tpu.parallel import replicate as jax_replicate
from ppn_tpu.parallel import shard_batch as jax_shard_batch
from ppn_tpu.train import steps as jst
from ppn_tpu_torch.parallel import Mesh, make_mesh, shard_batch, shard_rows
from ppn_tpu_torch.parallel import multihost
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.trainer import Trainer
from ppn_tpu_torch.utils.params_io import state_dict_from_jax_leaves

CLUSTER_ENVS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- mesh helpers, one process ---------------------------------------------

def test_mesh_helpers():
    mesh = make_mesh((-1,), ("data",), device="cpu")
    assert (mesh.shape, mesh.size(), mesh.rank(), mesh.group()) == (
        (1,), 1, 0, None)
    assert make_mesh((1, -1), ("data", "model"), device="cpu").shape == (1, 1)
    batch = {"x": np.arange(16).reshape(8, 2), "y": torch.ones(8, 3)}
    out = shard_batch(mesh, batch)
    np.testing.assert_array_equal(out["x"], batch["x"])
    assert torch.equal(out["y"], batch["y"])
    # a world of one cannot hold a mesh of two
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="at most one -1"):
        make_mesh((-1, -1), ("data", "model"), device="cpu")
    # rows of rank 1 of 2, and a batch the data axis does not divide
    two = Mesh((2, 1), ("data", "model"), torch.device("cpu"))
    assert shard_rows(two, 8) == slice(0, 4)
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(two, 5)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(two, {"x": np.zeros((7, 2))})


def test_trainer_refuses_a_batch_the_data_axis_does_not_divide():
    cfg = worker.config(batch_size=5)
    two = Mesh((2,), ("data",), torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(cfg, iter([]), device="cpu", mesh=two)


# ---- multihost.initialize: the JAX package's rules --------------------------

def _boom(message):
    def boom(*a, **k):
        raise RuntimeError(message)
    return boom


def test_initialize_raises_on_explicit_bad_args(monkeypatch):
    """Explicit coordinator args must propagate failures, never swallow
    them (a misconfigured cluster must not silently run single-process)."""
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        _boom("cannot reach coordinator"))
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost.initialize(coordinator_address="10.0.0.1:1234",
                             num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="not a rank"):
        multihost.initialize(coordinator_address="127.0.0.1:1234",
                             num_processes=2, process_id=2)
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize(coordinator_address="127.0.0.1:1234",
                             num_processes=2)


def test_initialize_noop_single_host(monkeypatch):
    for k in CLUSTER_ENVS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        _boom("no cluster"))
    multihost.initialize()  # must not raise
    assert not torch.distributed.is_initialized()
    # the real env:// rendezvous with nothing configured: also a no-op
    monkeypatch.undo()
    for k in CLUSTER_ENVS:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(backend="gloo")
    assert not torch.distributed.is_initialized()

    monkeypatch.setattr(torch.distributed, "init_process_group",
                        _boom("no cluster"))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9999")
    with pytest.raises(RuntimeError, match="no cluster"):
        multihost.initialize()


def test_initialize_raises_on_autodetected_cluster(monkeypatch):
    """SLURM/MPI launches and torchrun worlds (auto-detected, no
    coordinator env) must also fail loudly — each node silently training
    single-process with the same seed is the misconfiguration this guards
    against."""
    for k in CLUSTER_ENVS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        _boom("coordinator unreachable"))
    for envs in ({"SLURM_NTASKS": "8"}, {"OMPI_COMM_WORLD_SIZE": "4"},
                 {"PMI_SIZE": "2"},
                 {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1"}):
        for k, v in envs.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="unreachable"):
            multihost.initialize()
        for k in envs:
            monkeypatch.delenv(k)
    # a torchrun world of one rank, or no launcher address: not a cluster
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    multihost.initialize()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR")
    multihost.initialize()
    monkeypatch.delenv("WORLD_SIZE")
    multihost.initialize()  # clean single-host env: still a no-op


def test_is_primary():
    assert multihost.is_primary() is True


def test_global_batch_from_local_single_process():
    """One process: the local batch is the global one, on the device."""
    mesh = make_mesh(device="cpu")
    local = {"x": np.arange(32, dtype=np.float32).reshape(8, 4),
             "y": np.ones((8, 2, 3), np.float32)}
    out = multihost.global_batch_from_local(mesh, local)
    for k, v in local.items():
        assert isinstance(out[k], torch.Tensor)
        np.testing.assert_array_equal(out[k].numpy(), v)
    with pytest.raises(ValueError, match="disagree"):
        multihost.global_batch_from_local(
            mesh, {"x": np.zeros((8, 1)), "y": np.zeros((7, 1))})


# ---- two ranks over gloo ----------------------------------------------------

def _jax_bf16_state():
    """The JAX package's tiny_test state in bf16 at the worker's batch and
    optimizer settings."""
    jcfg = jax_get_config("tiny_test")
    c = worker.config("bfloat16")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, **{f.name: getattr(c.train, f.name)
                       for f in dataclasses.fields(c.train)
                       if f.name != "checkpoint_dir"}))
    return jcfg, jst.create_train_state(jcfg)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (tests/torch_dist_worker.py), the JAX state their
    bf16 step started from, and the output directory."""
    outdir = tmp_path_factory.mktemp("two_ranks")
    jcfg, (graphdef, jstate, tx) = _jax_bf16_state()
    leaves = [np.asarray(x) for x in jax.tree.leaves(
        {"params": jstate.params, "rest": jstate.rest})]
    torch.save(state_dict_from_jax_leaves(worker.config("bfloat16"), leaves),
               os.path.join(outdir, "jax_state.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(worker.main, args=(2, port, str(outdir)),
                                nprocs=2, join=True)
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
             for r in (0, 1)]
    return ranks, (jcfg, graphdef, jstate, tx), str(outdir)


def _max_rel(got: dict, want: dict) -> float:
    """The worst |got − want| / max|want| over the tensors of a state."""
    return max(float((got[k].float() - want[k].float()).abs().max())
               / max(float(want[k].float().abs().max()), 1e-30)
               for k in want)


def test_two_ranks_match_one_process_on_the_joined_batch(two_ranks,
                                                         tmp_path):
    ranks, _, _ = two_ranks
    cfg = worker.config(checkpoint_dir=str(tmp_path / "ckpt"))
    one = Trainer(cfg, iter([worker.global_batch()]), augment=True,
                  device="cpu")
    want_terms = one.run(1)
    want = one.state.model.state_dict()
    one.close()
    for r in ranks:
        for k, v in want_terms.items():
            assert abs(r["f32_terms"][k] - v) <= 1e-5 * abs(v), k
        assert _max_rel(r["f32_state"], want) <= 1e-5
    # the two ranks hold one replicated state, bit for bit
    assert all(torch.equal(v, ranks[1]["f32_state"][k])
               for k, v in ranks[0]["f32_state"].items())


def test_batchnorm_statistics_are_the_joined_batch(two_ranks):
    """The worker's two slices differ clearly in their statistics (dark and
    bright noise): BatchNorm over each slice alone, with the same
    augmentation draws and gradients averaged, lands far outside the
    tolerance the two ranks hold against one process."""
    ranks, _, _ = two_ranks
    cfg = worker.config()
    batch = worker.global_batch()
    losses, running = [], []
    for r in (0, 1):
        state = st.create_train_state(cfg, device="cpu")
        local = types.SimpleNamespace(rank=lambda axis="data", r=r: r,
                                      size=lambda axis="data": 2,
                                      group=lambda axis="data": None)
        terms, _ = st.loss_and_grads(
            cfg, state, {k: v[4 * r:4 * r + 4] for k, v in batch.items()},
            augment=True, mesh=local)
        losses.append(float(terms["loss_total"]))
        running.append(state.model.state_dict())
    got = ranks[0]["f32_terms"]["loss_total"]
    assert abs(np.mean(losses) - got) > 100 * 1e-5 * abs(got)
    for k in ("backbone.stem.bn.running_mean", "head.block.bn.running_var"):
        for r in (0, 1):
            assert _max_rel({k: running[r][k]},
                            {k: ranks[0]["f32_state"][k]}) > 100 * 1e-5


def test_two_ranks_bf16_match_the_jax_2_device_mesh(two_ranks):
    ranks, (jcfg, graphdef, jstate, tx), _ = two_ranks
    batch = worker.global_batch()
    batch["image"] = batch["image"].astype(np.float32) / 255.0
    mesh = jax_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    step = jst.make_train_step(jcfg, graphdef, tx)
    _, terms = step(jax_replicate(mesh, jstate), jax_shard_batch(mesh, batch))
    want = float(jax.device_get(terms["loss_total"]))
    for r in ranks:
        np.testing.assert_allclose(r["bf16_terms"]["loss_total"], want,
                                   rtol=2e-3)


def test_two_ranks_checkpoint_logs_and_refusals(two_ranks):
    ranks, _, outdir = two_ranks
    with open(os.path.join(outdir, "train_metrics.jsonl")) as fh:
        lines = fh.readlines()
    assert len(lines) == 1          # rank 0 alone logs, one step
    for r in ranks:
        assert r["ckpt_files"] == ["ckpt_00000001.pt"]
        assert r["resumed_step"] == 1 and r["resumed_equal"]
        assert "does not divide" in r["refusals"]["indivisible"]
        assert "between 3 and 4 rows" in r["refusals"]["unequal_rows"]
        assert r["local"]["image"] == (4, 64, 64, 3)
    # each rank gathered its half of the global index vector
    from ppn_tpu_torch.data.device_cache import DeviceCache

    full = DeviceCache(worker.dataset(), device="cpu").batch(
        np.arange(worker.GLOBAL_BATCH)[::-1])["image"]
    assert torch.equal(torch.cat([r["cache_image"] for r in ranks]), full)
