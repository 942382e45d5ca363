#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``ppn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device  — require CUDA; print the card's name and power limit; turn
               TF32 off for matmuls and cuDNN convs;
  2. build   — compile both kernels from the checkout's sources with nvcc
               for sm_90a, one nvcc per source, in parallel:
               ``ppn_post_kernel`` (ppn_tpu_torch/csrc/post.cu) and
               ``ppn_warp_kernel`` (ppn_tpu_torch/csrc/warp.cu);
  3. post kernel — against its plain PyTorch version on the card:
               tiny_test, mpii_r18_384 at B=1, 8, 128 and coco_r18_384_crowded
               at B=128; every decision field bitwise equal, float fields
               within 4 ulps;
  4. warp kernel — against its plain PyTorch version on the card, bitwise:
               mpii_r18_384 384² at B=32 with matrices drawn by
               ``sample_params`` and at B=6 with the unit tests' six
               matrices, bf16 and f32; tiny_test 64² likewise;
  5. inference path, part 1 — ``Predictor.from_npz`` on the committed MPII
               snapshot, PCKh over the 16-image synthetic protocol at B=8
               (det 0.02, nms 0.45): 0.9921 ± 3e-3 over 378 joints;
  6. inference path, part 2 — uint8 (128, 384, 384, 3) through
               ``Predictor.predict``: warm-up, then the median of 20 calls
               timed with CUDA events; the post kernel's own time beside its
               plain version's and its bound;
  7. train step, card against CPU — one ``train_step`` of tiny_test in f32
               (TF32 off), augmentation off, from the same parameters on
               both: loss terms within rel 1e-4;
  8. training path — mpii_r18_384 at B=32, bf16, augmentation on, 256
               synthetic images in the port's ``DeviceCache``, fine-tuning
               the committed MPII snapshot through ``Trainer.run`` for 30
               steps into a fresh checkpoint directory: finite losses, one
               warp launch per step, a new ``Trainer`` resumes the step and
               the parameters bitwise, ``Trainer.evaluate`` gives PCKh on
               the 16-image protocol through the post kernel;
  9. training times — the median step time over 20 steps and the
               CUDA-event times of augment, encode, forward+backward and
               optimizer+EMA over 10 steps;
 10. overfit  — mpii_r18_384 from a fresh init on 8 fixed images,
               augmentation off, constant lr 0.007, 60 steps: the mean
               loss_total of the last 10 steps under half the first's;
 11. warp kernel times at B=32 bf16 beside its plain version and its bound;
 12. report  — the kernels line, then the device line last.

Launch counts are set to 0 just before each path (phase 5 for inference,
phase 8 for training) and read just after it (phases 6 and 8); comparison
and timing launches fall outside those windows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet HBM rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
PINNED_PCKH, PINNED_JOINTS = 0.9921, 378
ULP_LIMIT = 4   # σ and box floats: same formula on both sides, so 0 is
                # expected; 4 leaves room for a different expf rounding
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
TRAIN_STEPS = 30
TRAIN_IMAGES = 256
OVERFIT_STEPS = 60
ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
# (angle, scale, tx, flip): the warp cases of tests/test_pallas_warp.py
WARP_CASES = [(0.0, 1.0, 0.0, False), (0.3, 1.1, 12.0, False),
              (-0.5, 0.8, -7.0, False), (0.7, 1.25, 3.0, True),
              (0.69, 3.9, 50.0, False), (-0.69, 0.26, -120.0, True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(got, want) -> tuple[bool, int, float]:
    """(decisions bitwise equal, max ulp, max abs error) of two People."""
    from ppn_tpu_torch.testing import max_ulp

    equal = all(torch.equal(getattr(got, f), getattr(want, f))
                for f in DECISIONS)
    ulp, err = 0, 0.0
    for f in FLOATS:
        g, w = getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy()
        ulp = max(ulp, max_ulp(g, w))
        err = max(err, float(np.abs(g - w).max(initial=0.0)))
    return equal, ulp, err


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound_ms(cfg, B: int) -> float:
    """Least time for ppn_post_kernel's work at batch B: the bytes it must
    move (the f32 map read once, the People fields written once) over the
    HBM rate. Its operation count depends on the NMS waves and is not
    counted, so the bound is by bytes."""
    H, W = cfg.outsize
    N, K1, P = H * W, cfg.num_classes, cfg.max_instances
    out_bytes = P * K1 * (2 * 4 + 4 * 4 + 4 + 1) + P * (1 + 4)
    nbytes = B * (N * cfg.num_channels * 4 + out_bytes)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def warp_bound_ms(images: torch.Tensor) -> float:
    """Least time for ppn_warp_kernel's work: each input pixel read once and
    each output pixel written once (the 24 bytes of matrices per image
    besides), over the HBM rate. Its ~60 f32 operations per pixel and
    channel are far below the card's f32 rate, so the bound is by bytes."""
    B = images.shape[0]
    nbytes = 2 * images.numel() * images.element_size() + B * 24
    return 1e3 * nbytes / HBM_BYTES_PER_S


def warp_matrices(cfg, B: int, dev, seed: int) -> torch.Tensor:
    """(B, 2, 3) matrices: the six test cases first, then draws of
    ``sample_params`` on the card for random person boxes."""
    from ppn_tpu_torch.ops.augment import sample_params
    from ppn_tpu_torch.ops.image import make_affine

    H, W = cfg.model.insize
    c = torch.tensor([W / 2.0, H / 2.0], device=dev)
    a, s, t, f = zip(*WARP_CASES)
    cases, _ = make_affine(
        c, c, torch.tensor(a, device=dev), torch.tensor(s, device=dev),
        torch.tensor([[x, -x] for x in t], device=dev),
        torch.tensor(f, device=dev))
    if B <= len(WARP_CASES):
        return cases[:B]
    rng = np.random.default_rng(seed)
    P = 4
    boxes = np.concatenate([rng.uniform(0, W, (B, P, 2)),
                            rng.uniform(8, W / 2, (B, P, 2))], -1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    drawn = sample_params(
        cfg.model, cfg.data, gen,
        torch.tensor(boxes, dtype=torch.float32, device=dev),
        torch.from_numpy(rng.random((B, P)) < 0.7).to(dev)).bwd
    return torch.cat([cases, drawn[len(WARP_CASES):]])


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


def main() -> int:
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                              heldout_dataset)
    from ppn_tpu_torch.eval.runner import evaluate_pckh
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_build, cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import affine_warp_separable_plain
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import KINDS, feature_map_case
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.trainer import Trainer

    card = smi_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build([cuda_post.SOURCE, cuda_warp.SOURCE],
                               force=True)
    log(f"[build] ppn_post_kernel and ppn_warp_kernel built in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for source, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {source}: {line.strip()}")

    # ---- 3. post kernel against plain on the card ---------------------------
    cases = [("tiny_test", 3), ("mpii_r18_384", 1), ("mpii_r18_384", 8),
             ("mpii_r18_384", 128), ("coco_r18_384_crowded", 128)]
    worst_ulp, worst_err = 0, 0.0
    for name, B in cases:
        m = get_config(name).model
        for kind in KINDS:
            fm = torch.from_numpy(feature_map_case(m, B, seed=B, kind=kind))
            fm = fm.to(dev)
            got = cuda_post.postprocess_batch_cuda(m, fm)
            want = postprocess_batch_plain(m, fm)
            torch.cuda.synchronize()
            equal, ulp, err = compare(got, want)
            worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
            log(f"[kernel] {name} B={B} {kind}: decisions_equal={equal} "
                f"max_ulp={ulp} max_abs_err={err:.3g} "
                f"persons={int(want.valid.sum())}")
            if not equal or ulp > ULP_LIMIT:
                raise AssertionError(f"kernel disagrees: {name} B={B} {kind}")

    # ---- 4. warp kernel against plain on the card ---------------------------
    mpii = get_config("mpii_r18_384")
    t0 = time.perf_counter()
    train_ds = SyntheticPoseDataset(mpii, size=TRAIN_IMAGES, seed=0,
                                    cache=True)
    cache = DeviceCache(train_ds, device=dev)
    log(f"[data] {TRAIN_IMAGES} synthetic images rendered and cached on the "
        f"card ({cache.nbytes() / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    tiny = get_config("tiny_test")
    tiny_img = torch.from_numpy(np.stack(
        [SyntheticPoseDataset(tiny, size=8, seed=3)[i]["image"]
         for i in range(8)])).to(dev)
    warp_err, warp_pixels = 0.0, 0
    for cfg_w, images in ((mpii, cache.data["image"][:32].float() / 255.0),
                          (tiny, tiny_img)):
        name = cfg_w.name
        for B in (images.shape[0], len(WARP_CASES)):
            mats = warp_matrices(cfg_w, B, dev, seed=B)
            for dt in (torch.bfloat16, torch.float32):
                x = images[:B].to(dt)
                got = cuda_warp.affine_warp_cuda(x, mats)
                want = affine_warp_separable_plain(x, mats)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                n_diff = int((d > 0).sum())
                warp_err = max(warp_err, float(d.max()))
                warp_pixels += d.numel()
                log(f"[warp] {name} B={B} {str(dt)[6:]}: differing values "
                    f"{n_diff} of {d.numel()}, max_abs_err "
                    f"{float(d.max()):.3g}")
                if n_diff:
                    raise AssertionError(
                        f"ppn_warp_kernel differs from its plain version: "
                        f"{name} B={B} {dt}")

    # ---- 5. inference path: snapshot PCKh through the kernel ----------------
    cfg = get_config("mpii_r18_384")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=0.02, nms_thresh=0.45))
    pred = Predictor.from_npz(cfg, SNAPSHOT)
    val = heldout_dataset(cfg, num_persons=2)
    calls = 0

    def predict(images):
        nonlocal calls
        calls += 1
        return pred.predict(images)

    cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
    t0 = time.perf_counter()
    summary = evaluate_pckh(cfg, predict, val, max_images=16, batch_size=8)
    pckh, joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[main] PCKh {pckh:.4f} over {joints:.0f} joints "
        f"({time.perf_counter() - t0:.1f} s, {calls} predict calls)")
    if abs(pckh - PINNED_PCKH) >= 3e-3 or joints != PINNED_JOINTS:
        raise AssertionError(f"PCKh {pckh} / {joints} joints, pinned "
                             f"{PINNED_PCKH} / {PINNED_JOINTS}")

    # ---- 6. inference path at full width: B=128 uint8 through predict ------
    B = 128
    images = np.random.default_rng(0).integers(
        0, 256, (B, *cfg.model.insize, 3), dtype=np.uint8)
    for _ in range(3):
        ppl = predict(images)
    for f in FLOATS:
        if not np.isfinite(getattr(ppl, f)).all():
            raise AssertionError(f"non-finite {f} at B={B}")
    ms = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        predict(images)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    launches = cuda_post.LAUNCHES
    med = statistics.median(ms)
    log(f"[main] B={B} predict: median {med:.3f} ms over {len(ms)} calls "
        f"(min {min(ms):.3f}, max {max(ms):.3f}) = {1e3 * B / med:.1f} img/s")
    log(f"[main] ppn_post_kernel launches {launches} over {calls} predict "
        f"calls; ppn_warp_kernel launches {cuda_warp.LAUNCHES}")
    if launches == 0 or launches != calls:
        raise AssertionError(f"{launches} kernel launches for {calls} calls")

    # ---- post kernel times at the inference path's shapes -------------------
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        fm128 = pred.model(x)
        fm1 = pred.model(x[:1])
    m = cfg.model
    got = cuda_post.postprocess_batch_cuda(m, fm128)
    want = postprocess_batch_plain(m, fm128)
    equal, ulp, err = compare(got, want)
    log(f"[kernel] main-path map B={B}: decisions_equal={equal} "
        f"max_ulp={ulp} max_abs_err={err:.3g}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("kernel disagrees on the main-path map")
    worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
    times = {}
    for b, fm in ((1, fm1), (B, fm128)):
        k_ms = time_ms(lambda: cuda_post.postprocess_batch_cuda(m, fm), 50)
        p_ms = time_ms(lambda: postprocess_batch_plain(m, fm), 5)
        bound = kernel_bound_ms(m, b)
        times[b] = (k_ms, p_ms, bound)
        log(f"[time] B={b}: ppn_post_kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {bound:.6f} ms (bytes) | {card}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: pred.model(x), 10)
    log(f"[time] B={B}: model forward {fwd_ms:.3f} ms | {card}")
    del pred, fm128, fm1, x

    # ---- 7. one train step on the card against the CPU ----------------------
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

    # ---- 8. training path: fine-tune at full width, resume, evaluate --------
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(
        ROOT, "build"))
    try:
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
        with open(os.path.join(ckpt_dir, "train_metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
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

        # ---- 9. training times ----------------------------------------------
        state = trainer.state
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
        log(f"[time] train step B={bs} bf16 with augmentation: median "
            f"{step_med:.3f} ms over {len(step_ms)} steps (min "
            f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
            f"{1e3 * bs / step_med:.1f} img/s | {card}")
        stages = train_stage_ms(train_cfg, state, next(batches), 10)
        log("[time] train step stages (CUDA events, mean of 10): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
            + f" | {card}")
        trainer.close()
        resumed.close()
        del trainer, resumed, state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- 10. overfit 8 fixed images from a fresh init ------------------------
    ocfg = dataclasses.replace(mpii, train=dataclasses.replace(
        mpii.train, lr_schedule="constant", warmup_steps=0,
        learning_rate=mpii.train.learning_rate))
    ostate = st.create_train_state(ocfg, device=dev)
    fixed = cache.batch(np.arange(8))
    curve = [float(st.train_step(ocfg, ostate, fixed)["loss_total"])
             for _ in range(OVERFIT_STEPS)]
    tail = statistics.fmean(curve[-10:])
    log(f"[overfit] loss_total first {curve[0]:.4f}, mean of the last 10 "
        f"{tail:.4f} after {OVERFIT_STEPS} steps (every 10th: "
        f"{[round(v, 3) for v in curve[::10]]})")
    if not all(math.isfinite(v) for v in curve) or not tail < 0.5 * curve[0]:
        raise AssertionError("the overfit check did not halve the loss")
    del ostate

    # ---- 11. warp kernel times at the training path's shape -----------------
    xw = cache.data["image"][:32].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    mw = warp_matrices(mpii, 32, dev, seed=32)
    w_ms = time_ms(lambda: cuda_warp.affine_warp_cuda(xw, mw), 50)
    wp_ms = time_ms(lambda: affine_warp_separable_plain(xw, mw), 5)
    w_bound = warp_bound_ms(xw)
    log(f"[time] B=32 384x384x3 bf16: ppn_warp_kernel {w_ms:.4f} ms, plain "
        f"{wp_ms:.3f} ms, bound {w_bound:.6f} ms (bytes) | {card}")

    # ---- 12. report ----------------------------------------------------------
    k_ms, p_ms, bound = times[B]
    k1_ms, p1_ms, bound1 = times[1]
    log(card)   # the nvidia-smi name,power.limit line, as it prints it
    log(json.dumps({"kernels": [{
        "name": "ppn_post_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/post.cu",
        "replaces": "ppn_tpu/ops/pallas_post_packed.py:584",
        "also_replaces": "ppn_tpu/ops/pallas_post.py:292",
        "launches": launches, "max_abs_err": worst_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "decisions_equal": True, "max_ulp": worst_ulp,
        "batch": B, "ms_b1": k1_ms, "plain_ms_b1": p1_ms,
        "bound_ms_b1": bound1, "predict_ms_b128": med,
        "img_per_s_b128": 1e3 * B / med, "forward_ms_b128": fwd_ms,
        "launches_training_path": post_train_launches,
    }, {
        "name": "ppn_warp_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/warp.cu",
        "replaces": "ppn_tpu/ops/pallas_warp.py:166",
        "launches": warp_launches, "max_abs_err": warp_err,
        "ms": w_ms, "plain_ms": wp_ms, "bound_ms": w_bound,
        "bound_by": "bytes", "library_ms": None,
        "batch": 32, "dtype": "bfloat16", "values_compared": warp_pixels,
        "train_step_ms_b32": step_med,
        "train_img_per_s_b32": 1e3 * bs / step_med,
        "train_stage_ms": stages, "overfit_first": curve[0],
        "overfit_last10_mean": tail,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
