"""The port's data-parallel slice (ppn_tpu_torch/parallel/, the global
BatchNorm statistics, the gradient all-reduce, the Trainer's mesh) on the
CPU: the mesh helpers and the rules of ``multihost.initialize`` (the cases
of tests/test_parallel.py:59-125), then a real 2-process gloo world
(tests/torch_dist_worker.py, spawned once for the module) against one
process on the joined batch and against the JAX package's 2-device mesh;
then, in a second world of the same two processes, the capacity-sharded
``DeviceCache`` (against the JAX package's per-device shards and the
replicated cache) and the K-step loop over it (the two-rank cases of
tests/test_device_cache.py and tests/test_multi_step.py).

Tolerances: one f32 step of two ranks against one process within rel 1e-5
on the loss terms and 1e-5·max|p| on every parameter and running
statistic (the sums run in another order: two halves, then the
all-reduce); the bf16 loss against the JAX package's 2-device mesh within
rel 2e-3, tests/test_parallel.py:155's tolerance for bf16 convs reduced
in other orders.
"""

import dataclasses
import os
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
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CLUSTER_ENVS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")
# the two ranks' deadline: about 4x their time under the suite's six
# workers, so a rank that hangs in a collective fails the module instead of
# holding its worker until the suite's clock runs out
TWO_RANKS_DEADLINE_S = 300


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


# global index blocks for the sharded cache of 10 rows (5 per rank)
SHARDED_BLOCKS = [[9, 1, 4, 0, 7, 2, 8, 3], [0, 0, 5, 4, 9, 9, 1, 6]]


def _sharded_cases(mesh, outdir: str) -> dict:
    """The capacity-sharded ``DeviceCache`` and the K-step loop on this
    rank (tests/test_device_cache.py:83-185, tests/test_multi_step.py:133
    and :180)."""
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.parallel import shard_batch
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.trainer import Trainer

    cfg = worker.config()
    ten = SyntheticPoseDataset(cfg, size=10, seed=5)    # 10 % 8 != 0 there
    sharded = DeviceCache(ten, device="cpu", mesh=mesh)
    replicated = DeviceCache(ten, device="cpu")
    resharded = DeviceCache(ten, device="cpu")
    resharded.reshard(mesh)
    small = DeviceCache(SyntheticPoseDataset(cfg, size=1, seed=7),
                        device="cpu", mesh=mesh)        # 1 row, 2 ranks
    out = {"rows": {"sharded": sharded.data, "resharded": resharded.data,
                    "small": small.data},
           "nbytes": [sharded.nbytes(), replicated.nbytes()],
           "gathered": [sharded.batch(b) for b in SHARDED_BLOCKS]
           + [resharded.batch(b) for b in SHARDED_BLOCKS]
           + [small.batch([0] * worker.GLOBAL_BATCH)],
           "replicated": [shard_batch(mesh, replicated.batch(b))
                          for b in SHARDED_BLOCKS]}

    # K=2 over the sharded cache against two train_step calls on the
    # replicated cache's slices: the same rows, the same calls
    kcfg = worker.config(steps_per_call=2)
    a = st.create_train_state(kcfg, device="cpu")
    b = st.create_train_state(kcfg, device="cpu")
    idx = np.asarray(SHARDED_BLOCKS, np.int32)
    multi = st.make_multi_train_step(kcfg, augment=True, steps_per_call=2,
                                     mesh=mesh)(a, sharded, idx)
    per = [st.train_step(kcfg, b, shard_batch(mesh, replicated.batch(i)),
                         augment=True, mesh=mesh) for i in idx]
    out["k_step_equal"] = (
        a.step == b.step == 2
        and all(torch.equal(v, b.model.state_dict()[k])
                for k, v in a.model.state_dict().items())
        and all(torch.equal(v, b.trace[k]) for k, v in a.trace.items())
        and all(torch.equal(v, b.ema[k]) for k, v in a.ema.items())
        and all(torch.equal(v, torch.stack([t[k] for t in per]).mean(0))
                for k, v in multi.items()))

    # the Trainer's K=2 loop over a cache built before the mesh (one block
    # and one step of the per-step tail), and the same three steps taken
    # one at a time by a Trainer on the replicated cache's slices
    cache = DeviceCache(ten, device="cpu")
    tcfg = worker.config(steps_per_call=2, resume=False,
                  checkpoint_dir=os.path.join(outdir, "ckpt_k"))
    trainer = Trainer(tcfg, cache.infinite_batches(worker.GLOBAL_BATCH, seed=0),
                      augment=True, device="cpu", device_cache=cache)
    terms = trainer.run(3)
    block = next(trainer._index_blocks(worker.GLOBAL_BATCH, 2,
                                     tcfg.train.seed))
    tail = next(replicated.infinite_batches(worker.GLOBAL_BATCH, seed=0))
    steps = Trainer(worker.config(resume=False,
                           checkpoint_dir=os.path.join(outdir, "ckpt_1")),
                    iter([shard_batch(mesh, replicated.batch(i))
                          for i in block] + [shard_batch(mesh, tail)]),
                    augment=True, device="cpu")
    want = steps.run(3)
    got_sd, want_sd = (t.state.model.state_dict() for t in (trainer, steps))
    out["trainer"] = {
        "step": trainer.step, "terms": terms,
        "equal_to_steps": (steps.step == 3 and terms == want and all(
            torch.equal(v, want_sd[k]) for k, v in got_sd.items())),
        "cache_sharded": cache.mesh is trainer.mesh,
        "cache_nbytes": cache.nbytes()}
    trainer.close()
    steps.close()

    # rank 0 reads the set from the render memo (written just before, so a
    # hit) while rank 1 renders it without one; then rank 1's fields in
    # reverse order: every rank packs and unpacks the same bytes anyway
    memo = os.path.join(outdir, f"memo{mesh.rank()}")
    saved = os.environ.get("PPN_SYNTH_CACHE")
    os.environ["PPN_SYNTH_CACHE"] = memo if mesh.rank() == 0 else "0"
    try:
        ten.materialize_collated()
        mixed = DeviceCache(ten, device="cpu", mesh=mesh)
    finally:
        if saved is None:
            del os.environ["PPN_SYNTH_CACHE"]
        else:
            os.environ["PPN_SYNTH_CACHE"] = saved
    out["memo_mixed"] = [mixed.batch(b) for b in SHARDED_BLOCKS]
    if mesh.rank() == 1:
        mixed.data = dict(reversed(mixed.data.items()))
    out["reordered"] = [mixed.batch(b) for b in SHARDED_BLOCKS]
    return out


def _two_rank_main(rank: int, world: int, ports, outdir: str) -> None:
    """One rank of the module's two-process world: tests/torch_dist_worker.py
    in a first gloo world, then ``_sharded_cases`` in a second, writing
    ``sharded<r>.pt`` (rank 0 hands out each world's port on ``ports``)."""
    from ppn_tpu_torch.parallel import make_mesh

    worker.main(rank, world, ports, outdir)
    _store = worker.join_world(rank, world, ports)  # rank 0's: the server
    out = {}
    try:
        out = _sharded_cases(make_mesh(device="cpu"), outdir)
    finally:
        torch.save(out, os.path.join(outdir, f"sharded{rank}.pt"))
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (tests/torch_dist_worker.py, and the sharded
    cases under "sharded"), the JAX state their bf16 step started from, and
    the output directory."""
    outdir = tmp_path_factory.mktemp("two_ranks")
    jcfg, (graphdef, jstate, tx) = _jax_bf16_state()
    leaves = [np.asarray(x) for x in jax.tree.leaves(
        {"params": jstate.params, "rest": jstate.rest})]
    torch.save(state_dict_from_jax_leaves(worker.config("bfloat16"), leaves),
               os.path.join(outdir, "jax_state.pt"))
    ports = torch.multiprocessing.get_context("spawn").Queue()
    worker.spawn(_two_rank_main, (2, ports, str(outdir)), 2,
                 TWO_RANKS_DEADLINE_S)
    ranks = [dict(torch.load(os.path.join(outdir, f"rank{r}.pt")),
                  sharded=torch.load(os.path.join(outdir, f"sharded{r}.pt")))
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


# ---- the capacity-sharded cache and the K-step loop on two ranks ------------

def _jax_shards(size: int, seed: int) -> list:
    """The JAX package's DeviceCache of tiny_test synthetic rows on a
    2-device mesh: each device's rows by field, in device order."""
    from ppn_tpu.data.device_cache import DeviceCache as JaxDeviceCache
    from ppn_tpu.data.synthetic import SyntheticPoseDataset as JaxDataset

    mesh = jax_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    cache = JaxDeviceCache(JaxDataset(jax_get_config("tiny_test"), size=size,
                                      seed=seed), mesh=mesh)
    return [{k: np.asarray(next(s.data for s in v.addressable_shards
                                if s.device == d))
             for k, v in cache.data.items()} for d in mesh.devices.flat]


def test_two_ranks_sharded_cache_holds_the_jax_device_shards(two_ranks):
    """tests/test_device_cache.py:83, :140 and :160 on two gloo ranks: each
    rank holds exactly the rows ``NamedSharding(P("data"))`` gives its
    device — built on the mesh, resharded after (both 10 rows, 5 each),
    and a dataset of 1 row padded cyclically to one row per rank — and
    half the replicated cache's bytes."""
    ranks, _, _ = two_ranks
    want = {"sharded": _jax_shards(10, 5), "resharded": _jax_shards(10, 5),
            "small": _jax_shards(1, 7)}
    for r, res in enumerate(ranks):
        rows = res["sharded"]["rows"]
        for label, shards in want.items():
            assert rows[label].keys() == shards[r].keys()
            for k, w in shards[r].items():
                got = rows[label][k].numpy()
                assert got.dtype == w.dtype and got.tobytes() == w.tobytes(), (
                    r, label, k)
        sharded_bytes, replicated_bytes = res["sharded"]["nbytes"]
        assert 2 * sharded_bytes == replicated_bytes


def test_two_ranks_sharded_gathers_are_the_replicated_caches(two_ranks):
    """tests/test_device_cache.py:56/:105/:185: the gathered slices of the
    sharded cache (built on the mesh, and resharded) bitwise the replicated
    cache's slices of the same global blocks, rows held by the other rank
    included; the 1-row cache gathers its one row on both ranks."""
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    ranks, _, _ = two_ranks
    small = DeviceCache(SyntheticPoseDataset(worker.config(), size=1, seed=7),
                        device="cpu").batch([0] * 4)
    for r, res in enumerate(ranks):
        got, want = res["sharded"]["gathered"], res["sharded"]["replicated"]
        for g, w in zip(got[:2] + got[2:4], want + want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
            assert len(g["image"]) == worker.GLOBAL_BATCH // 2
        for k, v in small.items():
            assert torch.equal(got[4][k], v), k
    # the first block's slices, joined, are the whole block's rows
    whole = DeviceCache(SyntheticPoseDataset(worker.config(), size=10, seed=5),
                        device="cpu").batch(SHARDED_BLOCKS[0])
    assert torch.equal(torch.cat([res["sharded"]["gathered"][0]["image"]
                                  for res in ranks]), whole["image"])


@pytest.mark.parametrize("case", ["memo_mixed", "reordered"])
def test_two_ranks_gather_whatever_each_ranks_field_order(two_ranks, case):
    """The gathered slices stay the replicated cache's when one rank read
    the render memo and the other rendered the set (a memo hit used to
    list its fields in file-name order, a render in ``collate``'s, and each
    rank unpacked the other's bytes in its own order: image bytes came back
    as boxes), and when one rank's fields are in reverse order."""
    ranks, _, _ = two_ranks
    for res in ranks:
        for g, w in zip(res["sharded"][case], res["sharded"]["replicated"]):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_two_ranks_k_step_loop_on_the_sharded_cache(two_ranks):
    """tests/test_multi_step.py:133 on two ranks: K=2 steps per call over
    the sharded cache are bitwise two ``train_step`` calls on the
    replicated cache's slices (state, traces, EMA and mean terms)."""
    ranks, _, _ = two_ranks
    assert all(res["sharded"]["k_step_equal"] for res in ranks)


def test_two_ranks_k_step_trainer_on_a_resharded_cache(two_ranks):
    """tests/test_multi_step.py:180 on two ranks: a ``Trainer`` with
    ``steps_per_call`` 2 adopts a cache built before its mesh (resharded,
    half the bytes) and runs one block and one step of the per-step tail:
    bitwise the same three steps taken one at a time on the replicated
    cache's slices (state and final terms), finite. Against one process
    the f32 runs part by the sums' other order, amplified step by step
    (2.5e-5·max|p| after two steps at lr 0.05); the one-step comparison
    above holds that order at 1e-5."""
    ranks, _, _ = two_ranks
    for res in ranks:
        got = res["sharded"]["trainer"]
        assert got["step"] == 3 and got["cache_sharded"]
        assert got["equal_to_steps"]
        assert 2 * got["cache_nbytes"] == res["sharded"]["nbytes"][1]
        assert all(np.isfinite(v) for v in got["terms"].values())
