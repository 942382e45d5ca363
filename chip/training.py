"""Phases 13-16, 18, 19, 24 and 25: training on the card — a step
against the CPU, the Trainer at full width, step times, an overfit, data
parallel on one and two ranks, the K-step loop and its CUDA graph, and the
capacity-sharded cache. The spawned ranks are this module's functions, so
a worker needs nothing of ``chip_smoke.py``."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from chip.context import (ROOT, SNAPSHOT, TRAIN_IMAGES, constant_lr,
                          free_port, log, max_rel_state, metrics, overfit,
                          quiet_call, same_state, scratch_dir)

TRAIN_STEPS = 30
DP_STEPS = 10            # phase 18: one rank against no group, bitwise
DP_BF16_STEPS = 5        # phase 19: two ranks against one process, bf16
K_STEPS = 4              # phase 24: steps per K-step call
# phase 24 at the benchmark's sizes: the configs, batch and steps per call
GRAPH_CONFIGS, GRAPH_B, GRAPH_K = ("mpii_r18_384", "mpii_hrw32_384"), 128, 8
# phase 24: the kernels counted by name in a profiler trace of a call
GRAPH_KERNELS = ("ppn_warp_kernel", "ppn_bn_")
SHARDED_BLOCKS = 4       # phase 25: global blocks gathered and compared


def train_stage_ms(cfg, state, batch, steps: int) -> dict:
    """Mean CUDA-event times (ms) of the stages of ``train_step`` over
    `steps` steps: the same calls as ``steps.loss_and_grads`` and
    ``steps.sgd_update``, with events between them."""
    from ppn_tpu_torch.ops.augment import augment_batch
    from ppn_tpu_torch.ops.encode import encode_batch
    from ppn_tpu_torch.train.loss import ppn_loss
    from ppn_tpu_torch.train.steps import sgd_update

    m, dev = cfg.model, state.device
    model = state.model.train()
    names, params = zip(*model.named_parameters())
    sums = [0.0] * 4
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        b = augment_batch(m, cfg.data, state.generator, batch, device=dev)
        ev[1].record()
        t = encode_batch(m, b["keypoints"], b["visible"], b["bboxes"],
                         b["valid"])
        ev[2].record()
        _, terms = ppn_loss(m, model(b["image"]), t)
        grads = dict(zip(names, torch.autograd.grad(terms["loss_total"],
                                                    params)))
        ev[3].record()
        sgd_update(cfg, state, grads)
        ev[4].record()
        torch.cuda.synchronize()
        for i in range(4):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    return dict(zip(("augment", "encode", "forward_backward",
                     "optimizer_ema"), (s / steps for s in sums)))


def dp_steps(cases: dict, mesh) -> dict:
    """For each case (label → (config, global batches on the host)): a train
    state from the snapshot, replicated over ``mesh``, takes one
    ``train_step`` with augmentation per batch on this rank's slice of it.
    Returns, by label, the loss terms of each step, each step's host ms
    (the device synchronized on both sides), the warp launches and the
    state after (on the host)."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.parallel import replicate, shard_batch
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    out = {}
    for label, (cfg, batches) in cases.items():
        state = st.create_train_state(cfg, device=mesh.device)
        load_npz_into_train_state(cfg, SNAPSHOT, state)
        replicate(mesh, state)
        cuda_warp.LAUNCHES = 0
        terms, ms = [], []
        for batch in batches:
            local = shard_batch(mesh, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = st.train_step(cfg, state, local, augment=True, mesh=mesh)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            terms.append({k: float(v) for k, v in t.items()})
        out[label] = {"terms": terms, "ms": ms,
                      "launches": cuda_warp.LAUNCHES,
                      "state": {k: v.cpu() for k, v in
                                state.model.state_dict().items()}}
    return out


@contextlib.contextmanager
def gloo_rank(rank: int, world: int, port: int, device: str):
    """This process as rank ``rank`` of a gloo world on the loopback address
    (NCCL refuses two ranks on one device), computing on ``device`` with
    TF32 off; yields its mesh."""
    import torch.distributed as dist

    from ppn_tpu_torch.parallel import make_mesh
    from ppn_tpu_torch.parallel.multihost import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        yield make_mesh(device=device)
    finally:
        dist.destroy_process_group()


def dp_rank(rank: int, world: int, port: int, outdir: str,
            cases: dict) -> None:
    """Phase 19's ranks: ``dp_steps`` on cuda:0, written to
    ``<outdir>/rank<r>.pt``."""
    with gloo_rank(rank, world, port, "cuda:0") as mesh:
        torch.save(dp_steps(cases, mesh),
                   os.path.join(outdir, f"rank{rank}.pt"))


def k_step_graph_case(name: str, cache, dev) -> dict:
    """Phase 24 at the benchmark's sizes: two K=8 calls of B=128 on a seeded
    ``name`` state (the first's first step eager, then a CUDA graph
    captured and replayed for the other fifteen steps) against 16
    ``train_step`` calls of a twin on the same blocks: the whole state and
    each call's mean terms bitwise; the ``ppn_warp_kernel`` and
    ``ppn_bn_*`` kernels of the second call, all replays, by a profiler
    trace against those of the eager steps on its block; the peak memory
    of each. cuDNN is held to its deterministic algorithms, so that eager
    steps are bitwise each other at this size."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.profiling import kernel_records

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=GRAPH_B, steps_per_call=GRAPH_K))
    rng = np.random.default_rng(2401)
    blocks = [np.stack([rng.choice(TRAIN_IMAGES, GRAPH_B, replace=False)
                        for _ in range(GRAPH_K)]).astype(np.int32)
              for _ in range(2)]

    def eager_call(state, idx):
        per = [st.train_step(cfg, state, cache.batch(i), augment=True)
               for i in idx]
        return {k: torch.stack([t[k] for t in per]).mean(0) for k in per[0]}

    def counters():
        return [st.EAGER_STEPS, st.GRAPH_CAPTURES, st.GRAPH_REPLAYS]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        b = st.create_train_state(cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        want = [eager_call(b, blocks[0])]
        out, eager = kernel_records(eager_call, b, blocks[1], device=dev,
                                    names=GRAPH_KERNELS)
        want.append(out)
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        a = st.create_train_state(cfg, device=dev)
        multi = st.make_multi_train_step(cfg, augment=True,
                                         steps_per_call=GRAPH_K)
        torch.cuda.reset_peak_memory_stats()
        c0 = counters()
        got = [multi(a, cache, blocks[0])]
        out, replayed = kernel_records(multi, a, cache, blocks[1],
                                       device=dev, names=GRAPH_KERNELS)
        got.append(out)
        graph = [x - y for x, y in zip(counters(), c0)]
        graph_peak = torch.cuda.max_memory_allocated()
        state_equal = same_state(a, b)
        terms_equal = all(
            g.keys() == w.keys() and all(torch.equal(v, w[k])
                                         for k, v in g.items())
            for g, w in zip(got, want))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del multi, a, b
    torch.cuda.empty_cache()
    out = {"state_equal": state_equal, "terms_equal": terms_equal,
           "graph_counts": graph, "replayed_kernels": replayed,
           "eager_kernels": eager, "eager_peak_gb": eager_peak / 1e9,
           "graph_peak_gb": graph_peak / 1e9,
           "loss_total": [float(t["loss_total"]) for t in got]}
    if (not state_equal or not terms_equal or replayed != eager
            or graph != [1, 1, 2 * GRAPH_K - 1]
            or eager["ppn_warp_kernel"] != GRAPH_K or eager["ppn_bn_"] == 0):
        raise AssertionError(f"K-step graph at {name}: {out}")
    return out


def sharded_rank(rank: int, world: int, port: int, outdir: str,
                 cases: dict, device: str) -> None:
    """Phase 25's ranks, on ``device`` (the card's cuda:0): the 256 cached
    images sharded over the world and replicated, their gathered slices
    compared, then each case's K=2 ``Trainer`` over the sharded cache;
    written to ``<outdir>/rank<r>.pt``."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.parallel import shard_batch

    with gloo_rank(rank, world, port, device) as mesh:
        ds = SyntheticPoseDataset(get_config("mpii_r18_384"),
                                  size=TRAIN_IMAGES, seed=0)
        sharded = DeviceCache(ds, device=mesh.device, mesh=mesh)
        replicated = DeviceCache(ds, device=mesh.device)
        rng = np.random.default_rng(25)
        B = cases["bf16"][0].train.batch_size
        equal = []
        for _ in range(SHARDED_BLOCKS):
            idx = rng.choice(TRAIN_IMAGES, B, replace=False)
            got = sharded.batch(idx)
            want = shard_batch(mesh, replicated.batch(idx))
            equal.append(all(torch.equal(v, want[k])
                             for k, v in got.items()))
        out = {"gathers_equal": equal,
               "nbytes": [sharded.nbytes(), replicated.nbytes()]}
        # with cuDNN's default algorithm choice two replays of these f32
        # steps part in the last bits on the H100 (PERF.md §6), so the
        # Trainer runs and the replay they are held to bitwise take its
        # deterministic algorithms; the default's replays are compared for
        # the record
        torch.backends.cudnn.deterministic = True
        out.update(k_step_trainer_runs(cases, sharded, mesh, outdir))
        replay = functools.partial(f32_replay, cases["f32"][0],
                                   out["f32"]["blocks"], replicated, mesh)
        out["f32"]["per_step_equal"] = same_tensors(out["f32"]["state"],
                                                    replay())
        torch.backends.cudnn.deterministic = False
        out["f32"]["default_replays_equal"] = same_tensors(replay(),
                                                           replay())
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def same_tensors(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(v, b[k])
                                        for k, v in a.items())


def f32_replay(cfg, blocks, cache, mesh) -> dict:
    """Phase 25's f32 Trainer run again, one ``train_step`` at a time on
    ``cache``'s slices of its index blocks, from the same start; the model
    state after, on the host."""
    from ppn_tpu_torch.parallel import replicate, shard_batch
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    state = load_npz_into_train_state(
        cfg, SNAPSHOT, st.create_train_state(cfg, device=mesh.device))
    replicate(mesh, state)
    for block in blocks:
        for row in block:
            st.train_step(cfg, state, shard_batch(mesh, cache.batch(row)),
                          augment=True, mesh=mesh)
    return {k: v.cpu() for k, v in state.model.state_dict().items()}


def k_step_trainer_runs(cases: dict, cache, mesh, outdir: str) -> dict:
    """For each case (label → (config, steps)): a ``Trainer`` from the
    snapshot over ``cache`` with augmentation, its K-step loop for the
    steps; the index blocks it drew, the logged (mean) loss terms of each
    block, the state after, the warp launches and the ms per step on the
    host clock."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.train.trainer import Trainer

    out = {}
    for label, (cfg, steps) in cases.items():
        d = os.path.join(outdir, f"{label}_{mesh.rank()}")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=d, resume=False, log_every=1,
            checkpoint_every=0, eval_every=0))
        trainer, _ = quiet_call(functools.partial(
            Trainer, cfg, iter([]), logdir=d, augment=True,
            init_npz=SNAPSHOT, device=mesh.device, mesh=mesh,
            device_cache=cache))
        k = cfg.train.steps_per_call
        draw = trainer._index_blocks(cfg.train.batch_size, k, cfg.train.seed)
        blocks = [next(draw).tolist() for _ in range(steps // k)]
        torch.cuda.synchronize()
        cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        quiet_call(trainer.run, steps)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        terms = [{k: v for k, v in r.items() if k.startswith("loss_")}
                 for r in (metrics(d) if mesh.rank() == 0 else [])]
        out[label] = {"terms": terms, "launches": cuda_warp.LAUNCHES,
                      "blocks": blocks,
                      "ms_per_step": ms, "state": {
                          k: v.cpu() for k, v in
                          trainer.state.model.state_dict().items()}}
        trainer.close()
    return out


def step_vs_cpu(ctx) -> dict:
    """Phase 13: one f32 tiny_test ``train_step`` on the card and on the CPU
    from the same parameters: loss terms within rel 1e-4."""
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.train import steps as st

    tiny, dev = ctx.tiny, ctx.dev
    tcfg = dataclasses.replace(tiny, train=dataclasses.replace(
        tiny.train, dtype="float32", lr_schedule="constant",
        warmup_steps=0, learning_rate=0.05, ema_decay=0.9))
    cpu_state = st.create_train_state(tcfg, device="cpu")
    gpu_state = st.create_train_state(tcfg, device=dev)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    tiny_batch = DeviceCache(SyntheticPoseDataset(tiny, size=2, seed=1),
                             device="cpu").batch([0, 1])
    want = st.train_step(tcfg, cpu_state, tiny_batch)
    got = st.train_step(tcfg, gpu_state, tiny_batch)
    rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in want if k.startswith("loss_")}
    log(f"[step] tiny_test f32 train step, card vs CPU, worst rel "
        f"{max(rel.values()):.3g} ({max(rel, key=rel.get)}); grad_norm "
        f"{float(got['grad_norm']):.6g} vs {float(want['grad_norm']):.6g}")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card and CPU train steps disagree: {rel}")
    return {}


def train_path(ctx) -> dict:
    """Phase 14: ``Trainer.run`` of 30 bf16 B=32 steps from the MPII
    snapshot over the cached images: finite losses, one warp launch a step,
    a new ``Trainer`` resumes bitwise, ``Trainer.evaluate`` through the post
    kernel. Phase 15 takes its state, batches and config."""
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.train.trainer import Trainer

    cfg, cache, val, dev = ctx.cfg, ctx.cache, ctx.val, ctx.dev
    with scratch_dir("ckpt_") as ckpt_dir:
        train_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt_dir, log_every=10,
            checkpoint_every=0, eval_every=0))
        batches = cache.infinite_batches(train_cfg.train.batch_size, seed=0)
        cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        trainer = Trainer(train_cfg, batches, val_dataset=val,
                          logdir=ckpt_dir, device_cache=cache,
                          init_npz=SNAPSHOT, device=dev)
        final = trainer.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        logged = metrics(ckpt_dir)
        losses = [r["loss_total"] for r in logged] + [final["loss_total"]]
        log(f"[train] {TRAIN_STEPS} steps at B={train_cfg.train.batch_size} "
            f"in {run_s:.1f} s (Trainer set-up included); loss_total at "
            f"steps {[r['step'] for r in logged]}: "
            f"{[round(v, 4) for v in losses[:-1]]}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        resumed = Trainer(train_cfg, batches, val_dataset=val, device=dev)
        a = trainer.state.model.state_dict()
        b = resumed.state.model.state_dict()
        same = all(torch.equal(a[k], b[k]) for k in a)
        log(f"[train] resumed at step {resumed.step}, parameters and "
            f"BatchNorm statistics bitwise equal: {same}")
        if resumed.step != TRAIN_STEPS or not same:
            raise AssertionError("resume did not restore the step and params")
        t0 = time.perf_counter()
        summary = resumed.evaluate(max_images=16, batch_size=8)
        warp_launches, post_train_launches = (cuda_warp.LAUNCHES,
                                              cuda_post.LAUNCHES)
        log(f"[train] PCKh after {TRAIN_STEPS} fine-tune steps "
            f"{summary['pckh/mean']:.4f} over "
            f"{summary['pckh/num_joints']:.0f} joints "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"[train] ppn_warp_kernel launches {warp_launches} over "
            f"{TRAIN_STEPS} steps; ppn_post_kernel launches "
            f"{post_train_launches} in the evaluation")
        if warp_launches != TRAIN_STEPS or post_train_launches == 0:
            raise AssertionError("the training path missed a kernel")
        if not math.isfinite(summary["pckh/mean"]):
            raise AssertionError("non-finite PCKh")
        trainer.close()
        resumed.close()
    return {"state": trainer.state, "batches": batches, "cfg": train_cfg,
            "kernels": {
                "ppn_post_kernel": {
                    "launches_training_path": post_train_launches},
                "ppn_warp_kernel": {"launches": warp_launches}}}


def train_times(ctx) -> dict:
    """Phase 15: the median step over 20 steps and the CUDA-event times of
    its stages over 10, on phase 14's state."""
    from ppn_tpu_torch.train import steps as st

    state, batches, train_cfg = (ctx.records["train_path"].pop(k)
                                 for k in ("state", "batches", "cfg"))
    step_ms = []
    for _ in range(20):
        batch = next(batches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st.train_step(train_cfg, state, batch, augment=True)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    step_med = statistics.median(step_ms)
    bs = train_cfg.train.batch_size
    return {"kernels": {"ppn_warp_kernel": {
        "train_step_ms_b32": step_med,
        "train_img_per_s_b32": 1e3 * bs / step_med,
        "train_stage_ms": train_stage_ms(train_cfg, state, next(batches),
                                         10)}}}


def overfit_fixed(ctx) -> dict:
    """Phase 16: mpii_r18_384 from a fresh init halves its loss on 8 fixed
    images in 60 steps (``overfit``)."""
    _, first, tail = overfit(ctx.mpii, ctx.fixed, ctx.dev, "[overfit]")
    return {"kernels": {"ppn_warp_kernel": {"overfit_first": first,
                                            "overfit_last10_mean": tail}}}


def dp_one_rank(ctx) -> dict:
    """Phase 18: ``Trainer`` of 10 bf16 steps from the snapshot over a
    ``DeviceCache`` on its mesh, as rank 0 of an NCCL world of one
    (``multihost.initialize`` from the launcher's environment) bitwise the
    same run with no process group (state, EMA, every step's terms); one
    warp launch a step; ``Trainer.evaluate`` under the mesh, two post
    launches."""
    import torch.distributed as dist

    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.parallel import make_mesh
    from ppn_tpu_torch.parallel.multihost import initialize
    from ppn_tpu_torch.train.trainer import Trainer

    cfg, train_ds, val, dev = ctx.cfg, ctx.train_ds, ctx.val, ctx.dev
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1"}
    runs = {}
    for label in ("no_group", "nccl"):
        d = tempfile.mkdtemp(prefix="dp1_", dir=os.path.join(ROOT, "build"))
        try:
            if label == "nccl":
                os.environ.update(env)
                initialize()
                if (dist.get_backend() != "nccl"
                        or dist.get_world_size() != 1):
                    raise AssertionError("the launcher's world did not join "
                                         "NCCL with one rank")
            mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, dev)
            batches = DeviceCache(train_ds, device=dev, mesh=mesh
                                  ).infinite_batches(cfg.train.batch_size,
                                                     seed=0)
            tcfg = constant_lr(cfg, checkpoint_dir=d, log_every=1,
                               checkpoint_every=0, eval_every=0, resume=False)
            cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
            trainer, _ = quiet_call(functools.partial(
                Trainer, tcfg, batches, val_dataset=val, logdir=d,
                init_npz=SNAPSHOT, device=dev, mesh=mesh))
            quiet_call(trainer.run, DP_STEPS)
            torch.cuda.synchronize()
            run = {"warp": cuda_warp.LAUNCHES,
                   "state": trainer.state.model.state_dict(),
                   "ema": trainer.state.ema}
            if label == "nccl":
                run["pckh"] = trainer.evaluate(max_images=16, batch_size=8)
                run["post"] = cuda_post.LAUNCHES
            run["terms"] = [{k: v for k, v in r.items()
                             if k.startswith("loss_") or k == "grad_norm"}
                            for r in metrics(d)]
            trainer.close()
            runs[label] = run
        finally:
            shutil.rmtree(d, ignore_errors=True)
            if label == "nccl":
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k in env:
                    os.environ.pop(k, None)
    ref, nccl = runs["no_group"], runs["nccl"]
    dp1_equal = {
        "state": all(torch.equal(v, nccl["state"][k])
                     for k, v in ref["state"].items()),
        "ema": (ref["ema"] is None) == (nccl["ema"] is None) and all(
            torch.equal(v, nccl["ema"][k])
            for k, v in (ref["ema"] or {}).items()),
        "terms": ref["terms"] == nccl["terms"]}
    differing = [(i, k) for i, (a, b) in enumerate(zip(ref["terms"],
                                                        nccl["terms"]))
                 for k in a if a[k] != b.get(k)]
    log(f"[dp1] {DP_STEPS} Trainer steps at B={cfg.train.batch_size} bf16 "
        f"with augmentation from the snapshot: rank 0 of an NCCL world of one "
        f"against no process group, bitwise equal {dp1_equal}; loss_total "
        f"{[round(t['loss_total'], 4) for t in nccl['terms']]}; "
        f"ppn_warp_kernel launches {nccl['warp']} (no group: {ref['warp']}); "
        f"Trainer.evaluate under the mesh: PCKh "
        f"{nccl['pckh']['pckh/mean']:.4f}, ppn_post_kernel launches "
        f"{nccl['post']}; (step, term) differing: {differing}")
    if (not all(dp1_equal.values()) or nccl["warp"] != DP_STEPS
            or ref["warp"] != DP_STEPS or nccl["post"] != 2):
        raise AssertionError(f"one-rank data parallel: {dp1_equal}, "
                             f"{nccl['warp']} warp and {nccl['post']} post "
                             "launches")
    dp1_report = {"bitwise_equal": dp1_equal, "warp_launches": nccl["warp"],
                  "post_launches_evaluate": nccl["post"],
                  "pckh": nccl["pckh"]["pckh/mean"]}
    return {"ninth_slice": {"data_parallel_one_rank": dp1_report},
            "kernels": {
                "ppn_post_kernel": {"launches_mesh_evaluate": nccl["post"]},
                "ppn_warp_kernel": {
                    "launches_data_parallel_one_rank": nccl["warp"]}}}


def dp_two_ranks(ctx) -> dict:
    """Phase 19: two spawned gloo ranks (``dp_rank``) on the one card
    against one process on the joined batch: f32 B=8 one step, terms within
    rel 1e-5 and the state within 1e-5·max|p|; bf16 B=32 5 steps,
    loss_total within rel 2e-3; one warp launch a step and rank."""
    from ppn_tpu_torch.parallel import make_mesh

    cfg, cache, dev = ctx.cfg, ctx.cache, ctx.dev
    f32 = constant_lr(cfg, dtype="float32", batch_size=8)
    bf16 = constant_lr(cfg)
    rng = np.random.default_rng(18)
    cases = {"f32": (f32, [{k: v.cpu() for k, v in cache.batch(
                 rng.choice(TRAIN_IMAGES, 8, replace=False)).items()}]),
             "bf16": (bf16, [{k: v.cpu() for k, v in cache.batch(
                 rng.choice(TRAIN_IMAGES, bf16.train.batch_size,
                            replace=False)).items()}
                 for _ in range(DP_BF16_STEPS)])}
    one = dp_steps(cases, make_mesh(device=dev))
    with scratch_dir("dp2_") as d:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(dp_rank, args=(2, free_port(), d, cases),
                                    nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
                 for r in (0, 1)]
    dp2 = {"spawn_s": spawn_s}
    for r, res in enumerate(ranks):
        want = one["f32"]["terms"][0]
        got = res["f32"]["terms"][0]
        terms_rel = max(abs(got[k] - want[k]) / abs(want[k])
                        for k in want if k.startswith("loss_"))
        state_rel, worst = max_rel_state(res["f32"]["state"],
                                         one["f32"]["state"])
        bf16_rel = max(abs(g["loss_total"] - w["loss_total"])
                       / abs(w["loss_total"]) for g, w in
                       zip(res["bf16"]["terms"], one["bf16"]["terms"]))
        dp2[f"rank{r}"] = {
            "f32_loss_rel": terms_rel, "f32_state_rel": state_rel,
            "f32_worst_tensor": worst, "bf16_loss_rel": bf16_rel,
            "launches": [res["f32"]["launches"], res["bf16"]["launches"]],
            "bf16_step_ms_median": statistics.median(res["bf16"]["ms"])}
        if (terms_rel > 1e-5 or state_rel > 1e-5 or bf16_rel > 2e-3
                or res["f32"]["launches"] != 1
                or res["bf16"]["launches"] != DP_BF16_STEPS):
            raise AssertionError(f"two-rank step disagrees: {dp2}")
    dp2["one_process_bf16_step_ms_median"] = statistics.median(
        one["bf16"]["ms"])
    return {"ninth_slice": {"data_parallel_two_ranks": dp2}, "kernels": {
        "ppn_warp_kernel": {"launches_per_rank_two_ranks": [
            dp2[f"rank{r}"]["launches"] for r in (0, 1)]}}}


def k_step(ctx) -> dict:
    """Phase 24: one K=4 ``make_multi_train_step`` call (a first eager step,
    then replays of its CUDA graph) bitwise 4 ``train_step`` calls on the
    same block, state and mean terms; a traced second call runs 4
    ``ppn_warp_kernel`` and 6 ``ppn_bn_*`` kernels per BatchNorm layer and
    step; ms per step of both, in turns; then ``k_step_graph_case`` at the
    benchmark's sizes."""
    from ppn_tpu_torch.nn.resnet import BatchNorm
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state
    from ppn_tpu_torch.utils.profiling import kernel_records

    cfg, cache, dev = ctx.cfg, ctx.cache, ctx.dev
    kcfg = constant_lr(cfg, steps_per_call=K_STEPS)
    B = kcfg.train.batch_size
    a, b = (load_npz_into_train_state(
        kcfg, SNAPSHOT, st.create_train_state(kcfg, device=dev))
        for _ in range(2))
    rng = np.random.default_rng(24)

    def block():
        return np.stack([rng.choice(TRAIN_IMAGES, B, replace=False)
                         for _ in range(K_STEPS)]).astype(np.int32)

    idx = block()
    multi = st.make_multi_train_step(kcfg, augment=True,
                                     steps_per_call=K_STEPS)
    per = [st.train_step(kcfg, b, cache.batch(i), augment=True) for i in idx]
    torch.cuda.synchronize()
    got = multi(a, cache, idx)
    torch.cuda.synchronize()
    bn_layers = sum(isinstance(m, BatchNorm) for m in a.model.modules())
    mean = {k: torch.stack([t[k] for t in per]).mean(0) for k in per[0]}
    terms_equal = got.keys() == mean.keys() and all(
        torch.equal(v, mean[k]) for k, v in got.items())
    state_equal = same_state(a, b)
    _, records = kernel_records(multi, a, cache, block(), device=dev,
                                names=GRAPH_KERNELS)
    launches, bn_launches = (records[n] for n in GRAPH_KERNELS)
    k_ms, s_ms = [], []
    for _ in range(4):                  # in turns: K-step, per-step
        for label, ms in (("k", k_ms), ("s", s_ms)):
            i = block()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "k":
                multi(a, cache, i)
            else:
                for row in i:
                    st.train_step(kcfg, b, cache.batch(row), augment=True)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / K_STEPS)
    out = {"state_equal": state_equal, "terms_equal": terms_equal,
           "warp_launches_per_call": launches,
           "bn_launches_per_call": bn_launches, "bn_layers": bn_layers,
           "loss_total": float(got["loss_total"]),
           "k_step_ms_per_step": statistics.median(k_ms),
           "per_step_ms_per_step": statistics.median(s_ms),
           "k_step_ms_all": k_ms, "per_step_ms_all": s_ms}
    if (not state_equal or not terms_equal or launches != K_STEPS
            or bn_launches != 6 * bn_layers * K_STEPS):
        raise AssertionError(f"K-step loop: {out}")
    del multi, a, b
    torch.cuda.empty_cache()
    out["bench_sizes"] = {name: k_step_graph_case(name, cache, dev)
                          for name in GRAPH_CONFIGS}
    return {"eleventh_slice": {"k_step": out}, "kernels": {
        "ppn_warp_kernel": {"launches_per_k_step_call": launches},
        "ppn_bn_*": {"launches_per_k_step_call": bn_launches,
                     "batch_norm_layers": bn_layers}}}


def sharded_cache(ctx) -> dict:
    """Phase 25: two spawned gloo ranks (``sharded_rank``) on the one card
    over the capacity-sharded cache: gathers bitwise the replicated
    cache's, half its bytes each; a K=2 ``Trainer``, its f32 state bitwise
    the same steps taken one at a time, its terms against one process
    within phase 19's limits; K warp launches a call and rank."""
    from ppn_tpu_torch.parallel import make_mesh

    cfg, cache = ctx.cfg, ctx.cache
    cases = {"f32": (constant_lr(cfg, dtype="float32", batch_size=8,
                                 steps_per_call=2), 2),
             "bf16": (constant_lr(cfg, steps_per_call=2), 4)}
    with scratch_dir("sharded_") as d:
        torch.backends.cudnn.deterministic = True    # as the ranks run
        one = k_step_trainer_runs(cases, cache, make_mesh(device=cache.device),
                                  os.path.join(d, "one_process"))
        torch.backends.cudnn.deterministic = False
        t0 = time.perf_counter()
        dev = cache.device
        device = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        torch.multiprocessing.spawn(
            sharded_rank, args=(2, free_port(), d, cases, device),
            nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
                 for r in (0, 1)]
    out = {"spawn_s": spawn_s, "one_process_ms_per_step": {
        k: v["ms_per_step"] for k, v in one.items()}}
    got0 = ranks[0]
    f32_rel = max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(got0["f32"]["terms"], one["f32"]["terms"])
                  for k in w)
    bf16_rel = max(abs(g["loss_total"] - w["loss_total"])
                   / abs(w["loss_total"]) for g, w in
                   zip(got0["bf16"]["terms"], one["bf16"]["terms"]))
    for r, res in enumerate(ranks):
        state_rel, worst = max_rel_state(res["f32"]["state"],
                                         one["f32"]["state"])
        out[f"rank{r}"] = {
            "gathers_equal": res["gathers_equal"],
            "cache_bytes": res["nbytes"][0],
            "replicated_bytes": res["nbytes"][1],
            "f32_state_rel": state_rel, "f32_worst_tensor": worst,
            "launches": [res["f32"]["launches"], res["bf16"]["launches"]],
            "ms_per_step": [res["f32"]["ms_per_step"],
                            res["bf16"]["ms_per_step"]]}
        out[f"rank{r}"].update(
            f32_per_step_equal=res["f32"]["per_step_equal"],
            default_cudnn_replays_equal=res["f32"]["default_replays_equal"])
        if (not all(res["gathers_equal"])
                or not res["f32"]["per_step_equal"]
                or 2 * res["nbytes"][0] != res["nbytes"][1]
                or res["f32"]["launches"] != 2
                or res["bf16"]["launches"] != 4):
            raise AssertionError(f"sharded cache rank {r}: {out}")
    out.update(f32_terms_rel=f32_rel, bf16_loss_rel=bf16_rel)
    if (f32_rel > 1e-5 or bf16_rel > 2e-3
            or len(got0["bf16"]["terms"]) != 2
            or len(got0["f32"]["terms"]) != 1):
        raise AssertionError(f"sharded K=2 Trainer against one process: {out}")
    return {"eleventh_slice": {"sharded_cache": out}, "kernels": {
        "ppn_warp_kernel": {"launches_sharded_k_step_per_rank": [
            out[f"rank{r}"]["launches"] for r in (0, 1)]}}}
