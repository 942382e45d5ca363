"""One rank of the port's 2-process data-parallel test
(``tests/test_torch_parallel.py``): a gloo world on the CPU, tiny_test at a
global batch of 8, 4 rows per rank. Imports no JAX.

Each rank writes ``rank<r>.pt`` into the output directory: the loss terms
and state after one f32 ``Trainer`` step with augmentation (and what a
resumed ``Trainer`` and the primary-only checkpoint left), the loss terms
of one bf16 step from the parameters in ``jax_state.pt``, the rows its
``DeviceCache`` gathered, and the messages of the refusals it met. The
test starts both ranks with ``spawn(main, (2, ports, outdir), 2,
deadline_s)``, ``ports`` a queue of the spawn context through which rank 0
hands out the port of each world it opens (``join_world``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

GLOBAL_BATCH = 8
# how long a rank waits for rank 0 to hand it a world's port
PORT_WAIT_S = 120


def spawn(fn, args: tuple, nprocs: int, deadline_s: float) -> None:
    """``torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs)`` joined
    against a deadline. A rank that raises fails the call at once (spawn
    terminates the others); ranks still alive ``deadline_s`` seconds after
    the start are killed, and the call raises ``TimeoutError`` naming
    them."""
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs,
                                      join=False)
    end = time.monotonic() + deadline_s
    while not ctx.join(timeout=max(0.0, end - time.monotonic())):
        if time.monotonic() < end:
            continue
        alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(30)
        raise TimeoutError(
            ", ".join(f"rank {r}" for r in alive)
            + f" still alive after the {deadline_s:g} s deadline: killed")


def join_world(rank: int, world: int, ports):
    """Join a gloo world on a port that no other process can take between
    its choice and its use: rank 0 binds port 0 in a ``TCPStore`` server,
    which ``multihost.initialize``'s rendezvous then shares (a store on the
    same port in the same process is one server: ``multi_tenant``), and
    puts the port on ``ports`` once for every other rank. Returns rank 0's
    store, which must outlive the world (None on the other ranks)."""
    from ppn_tpu_torch.parallel.multihost import initialize

    store = None
    if rank == 0:
        store = torch.distributed.TCPStore("127.0.0.1", 0, world, True,
                                           wait_for_workers=False,
                                           multi_tenant=True)
        port = store.port
        for _ in range(world - 1):
            ports.put(port)
    else:
        port = ports.get(timeout=PORT_WAIT_S)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    return store


def sleeping_rank(rank: int, pid_dir: str, seconds: float) -> None:
    """A rank that records its pid in ``pid_dir`` and sleeps ``seconds``
    times its rank: rank 0 ends at once (the deadline test's rank)."""
    with open(os.path.join(pid_dir, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(seconds * rank)


def config(dtype: str = "float32", **train):
    """tiny_test at the global batch, a constant lr of 0.05 and EMA 0.9,
    logging every step, no periodic checkpoint or eval."""
    from ppn_tpu_torch.configs import get_config

    cfg = get_config("tiny_test")
    train = dict(dict(
        batch_size=GLOBAL_BATCH, dtype=dtype, lr_schedule="constant",
        warmup_steps=0, learning_rate=0.05, ema_decay=0.9, log_every=1,
        checkpoint_every=0, eval_every=0), **train)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **train))


def dataset():
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    return SyntheticPoseDataset(config(), size=GLOBAL_BATCH, seed=1)


def global_batch() -> dict:
    """Synthetic GT for 8 images of seeded uint8 noise, the first four dark
    and the last four bright: the two ranks' slices have clearly different
    per-channel statistics, so BatchNorm over one slice alone is far from
    BatchNorm over the joined batch."""
    from ppn_tpu_torch.data.pipeline import collate

    ds = dataset()
    b = collate([ds[i] for i in range(GLOBAL_BATCH)], image_uint8=True)
    shape = b["image"].shape[1:]
    rng = np.random.default_rng(0)
    b["image"] = np.concatenate([
        rng.integers(0, 80, (GLOBAL_BATCH // 2, *shape)),
        rng.integers(170, 256, (GLOBAL_BATCH // 2, *shape))]).astype(np.uint8)
    return {k: b[k] for k in ("image", "keypoints", "visible", "bboxes",
                              "valid")}


def main(rank: int, world: int, ports, outdir: str) -> None:
    torch.set_num_threads(1)
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.parallel import make_mesh, shard_batch
    from ppn_tpu_torch.parallel.multihost import global_batch_from_local
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.trainer import Trainer

    _store = join_world(rank, world, ports)  # rank 0's: the world's server
    out = {}
    try:
        mesh = make_mesh(device="cpu")
        ckpt = os.path.join(outdir, "ckpt")
        cfg = config(checkpoint_dir=ckpt)
        trainer = Trainer(cfg, iter([shard_batch(mesh, global_batch())]),
                          logdir=outdir, augment=True, device="cpu")
        out["f32_terms"] = trainer.run(1)
        out["f32_state"] = trainer.state.model.state_dict()
        out["ckpt_files"] = sorted(os.listdir(ckpt))
        resumed = Trainer(cfg, iter([]), device="cpu")
        restored = resumed.state.model.state_dict()
        out["resumed_step"] = resumed.step
        out["resumed_equal"] = all(torch.equal(v, restored[k])
                                   for k, v in out["f32_state"].items())
        trainer.close()
        resumed.close()

        bcfg = config("bfloat16")
        state = st.create_train_state(bcfg, device="cpu")
        state.model.load_state_dict(
            torch.load(os.path.join(outdir, "jax_state.pt")))
        batch = global_batch()
        batch["image"] = batch["image"].astype(np.float32) / 255.0
        terms = st.train_step(bcfg, state, shard_batch(mesh, batch),
                              mesh=mesh)
        out["bf16_terms"] = {k: float(v) for k, v in terms.items()}

        idx = np.arange(GLOBAL_BATCH)[::-1]
        out["cache_image"] = DeviceCache(dataset(), device="cpu",
                                         mesh=mesh).batch(idx)["image"]
        refusals = {}
        try:
            Trainer(config(batch_size=5), iter([]), device="cpu")
        except ValueError as e:
            refusals["indivisible"] = str(e)
        try:
            global_batch_from_local(mesh, {"x": np.zeros((4 - rank, 2))})
        except ValueError as e:
            refusals["unequal_rows"] = str(e)
        out["refusals"] = refusals
        out["local"] = {k: v.shape for k, v in global_batch_from_local(
            mesh, shard_batch(mesh, global_batch())).items()}
    finally:
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
