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
               at B=128 on the ``normal``, ``sparse``, ``ties`` and ``nan``
               maps (``nan``: 1% of the limb logits and a few proposal
               logits NaN), the edge cases: no proposal above the threshold
               (``empty``), every proposal above it in NMS chains
               (``chain``, MPII and COCO), B=133 (more CTAs than SMs), and
               the NaN window case (``nan_window_case``: one NaN limb logit
               beside its window's winner, so no winner) on all three
               configs; every decision field bitwise equal, float fields
               within 4 ulps (NaN where the other is NaN);
  4. warp kernel — against its plain PyTorch version on the card, bitwise:
               mpii_r18_384 384² at B=32 with matrices drawn by
               ``sample_params`` and at B=6 with the unit tests' six
               matrices, bf16 and f32; tiny_test 64² likewise; the edge
               cases 64×97 (a width no tile divides) at C=1, 3, 4 and 384²
               at B=1;
  5. inference path, part 1 — ``Predictor.from_npz`` on the committed MPII
               snapshot, PCKh over the 16-image synthetic protocol at B=8
               (det 0.02, nms 0.45): 0.9921 ± 3e-3 over 378 joints;
  6. inference path, part 2 — uint8 (128, 384, 384, 3) through
               ``Predictor.predict``: warm-up, then the median of 20 calls
               timed with CUDA events; the post kernel's own time (a CUDA
               graph of 50 launches, and back to back through the wrapper
               with the wrapper's host time per call) beside its plain
               version's and its bounds (the whole map, and the bytes this
               input needs), and its stage split from the kernel's
               %globaltimer stamps at B=1 and B=128 on the main-path map and
               on the ``normal`` map;
  7. flip-TTA — ``Predictor.from_npz(..., flip_tta=True)``, PCKh on the same
               protocol: 0.9894 ± 3e-3 over 378 joints (the JAX package's
               TTA on its CPU), one post launch per predict call; then the
               median of 20 B=128 TTA predicts;
  8. evaluation — COCO OKS AP through ``Predictor`` and
               ``eval/runner.evaluate_oks`` on 16 held-out synthetic images
               at B=8, against the JAX package's values on its CPU within
               5e-3: the COCO snapshot (det 0.02, nms 0.6, 2 persons)
               0.945134 over 32 GT, the same with flip-TTA 0.972408, the
               crowd snapshot (5 persons) 0.862841 over 80; two post
               launches each; wall time per evaluated image, cold and warm,
               and its share in predict; then ``apps/evaluate.main
               --metric oks`` on the COCO snapshot, with the thresholds as
               flags and from a config.ini: its JSON equal to the library's
               summary rounded to 4 places;
  9. B=1 latency — ``predict_single`` on uint8 384² images, p50 and p90 of
               200 calls after warm-up, without and with TTA, and the split
               of one call: upload, forward, post (kernel device time and
               the wrapper's host time), download;
 10. server   — ``apps/serve.main`` self-test on the snapshot (64 requests,
               8 client threads, max batch 32, 5 ms window): every request
               bitwise equal to a direct predict at a bucket the server used,
               and one post launch per predict call (warm-up, batches, the
               check's direct predicts);
 11. video    — ``apps/video.main`` on 64 synthetic 720p frames at 30 fps
               with the on-device resize, pipelined and with
               ``--no-overlap``: one post launch per frame (the warm-up
               frame besides); the first frame's People through the kernel
               equal to the plain pipeline's (resize, model,
               ``postprocess_batch_plain``) in every decision field;
 12. train step, card against CPU — one ``train_step`` of tiny_test in f32
               (TF32 off), augmentation off, from the same parameters on
               both: loss terms within rel 1e-4;
 13. training path — mpii_r18_384 at B=32, bf16, augmentation on, 256
               synthetic images in the port's ``DeviceCache``, fine-tuning
               the committed MPII snapshot through ``Trainer.run`` for 30
               steps into a fresh checkpoint directory: finite losses, one
               warp launch per step, a new ``Trainer`` resumes the step and
               the parameters bitwise, ``Trainer.evaluate`` gives PCKh on
               the 16-image protocol through the post kernel;
 14. training times — the median step time over 20 steps and the
               CUDA-event times of augment, encode, forward+backward and
               optimizer+EMA over 10 steps;
 15. overfit  — mpii_r18_384 from a fresh init on 8 fixed images,
               augmentation off, constant lr 0.007, 60 steps: the mean
               loss_total of the last 10 steps under half the first's;
 16. warp kernel times at B=32 bf16 (a CUDA graph of 50 launches, and back
               to back) beside its plain version and its bound;
 17. report  — the serving and evaluation slices' numbers, the kernels
               line, then the device line last.

Launch counts are set to 0 just before each path (phase 5 for inference,
7 for TTA, 8 for each evaluation and CLI run, 9 for B=1, 10 for the server,
11 for video, 13 for training) and read just after it; comparison and
timing launches fall outside those windows.
"""

from __future__ import annotations

import dataclasses
import functools
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
# flip-TTA on the same protocol: the JAX package's value on its CPU
# (train/steps.make_forward(flip_tta=True) through eval/runner.evaluate_pckh)
PINNED_TTA_PCKH = 0.98942
LATENCY_CALLS = 200
VIDEO_FRAMES = 64
ULP_LIMIT = 4   # σ and box floats: same formula on both sides, so 0 is
                # expected; 4 leaves room for a different expf rounding
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
TRAIN_STEPS = 30
TRAIN_IMAGES = 256
OVERFIT_STEPS = 60
ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
COCO_SNAPSHOT = os.path.join(ROOT, "artifacts", "coco_hero_r3_ema_f16.npz")
CROWD_SNAPSHOT = os.path.join(ROOT, "artifacts", "crowd_hero_r5_ema_f16.npz")
# COCO OKS AP of the JAX package on its CPU (train/steps.make_forward through
# eval/runner.evaluate_oks), 16 held-out synthetic images at B=8:
# label -> (config, snapshot, persons, det/nms, flip-TTA, AP, GT persons)
OKS_PINS = {
    "coco": ("coco_r18_384", COCO_SNAPSHOT, 2, (0.02, 0.6), False,
             0.945134, 32),
    "coco_tta": ("coco_r18_384", COCO_SNAPSHOT, 2, (0.02, 0.6), True,
                 0.972408, 32),
    "crowd": ("coco_r18_384_crowded", CROWD_SNAPSHOT, 5, None, False,
              0.862841, 80),
}
OKS_TOLERANCE = 5e-3   # about one match flipped at one of the ten OKS
                       # thresholds among 32 GT: bf16 cuDNN logits against
                       # the CPU's
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
        ulp = max(ulp, max_ulp(g, w))       # a lone NaN counts as 2**32
        d = np.abs(g - w)
        err = max(err, float(np.where(np.isnan(d), 0.0, d).max(initial=0.0)))
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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call with `reps` calls captured in a CUDA
    graph and replayed: each kernel and its launch, without the host's
    per-call Python work (which bounds `time_ms` for a kernel of a few tens
    of µs)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int) -> float:
    """Median over `reps` single calls of the CUDA-event time around one
    call (for a call the host cannot keep ahead of, its enqueue time)."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def percentiles_ms(fn, calls: int) -> tuple[float, float]:
    """p50 and p90 of the host-clock time of `calls` calls of `fn`, each
    ending with its results on the host."""
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        lat.append(1e3 * (time.perf_counter() - t0))
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 90)))


def quiet_call(fn, *args):
    """fn(*args) with its standard output captured: (result, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def host_us(fn, reps: int) -> float:
    """Mean host time of one call over `reps` calls enqueued back to back
    (µs; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def whole_map_bound_ms(cfg, B: int) -> float:
    """ppn_post_kernel's bound if it read the whole f32 map: the map read
    once and the People fields written once, over the HBM rate."""
    from ppn_tpu_torch.ops.cuda_post import output_bytes

    H, W = cfg.outsize
    nbytes = B * (H * W * cfg.num_channels * 4 + output_bytes(cfg))
    return 1e3 * nbytes / HBM_BYTES_PER_S


def kernel_bound_ms(cfg, fm: torch.Tensor) -> float:
    """Least time for ppn_post_kernel's work on this map: the bytes this
    input needs (``cuda_post.needed_bytes``: the proposal channels, the limb
    logits whose destination keeps a score, the outputs) over the HBM rate.
    Its operation count depends on the data through NMS and is not
    counted, so the bound is by bytes."""
    from ppn_tpu_torch.ops.cuda_post import needed_bytes

    return 1e3 * needed_bytes(cfg, fm) / HBM_BYTES_PER_S


def post_stage_us(cfg, fm: torch.Tensor, reps: int) -> tuple[dict, float]:
    """Mean µs of each ppn_post_kernel stage over the CTAs of `reps`
    launches, from the kernel's %globaltimer stamps; and the mean span of a
    launch, from the first CTA's entry to the last CTA's end (µs)."""
    from ppn_tpu_torch.ops import cuda_post

    clocks = torch.zeros((fm.shape[0], len(cuda_post.STAGES) + 1),
                         dtype=torch.int64, device=fm.device)
    sums, span = dict.fromkeys(cuda_post.STAGES, 0.0), 0.0
    for _ in range(reps):
        cuda_post.postprocess_batch_cuda(cfg, fm, stage_clocks=clocks)
        torch.cuda.synchronize()
        for k, v in cuda_post.stage_us(clocks).items():
            sums[k] += v / reps
        span += float(clocks[:, -1].max() - clocks[:, 0].min()) / 1e3 / reps
    return sums, span


def warp_bound_ms(images: torch.Tensor) -> float:
    """Least time for ppn_warp_kernel's work: each input pixel read once and
    each output pixel written once (the 24 bytes of matrices per image
    besides), over the HBM rate. Its ~60 f32 operations per pixel and
    channel are far below the card's f32 rate, so the bound is by bytes."""
    B = images.shape[0]
    nbytes = 2 * images.numel() * images.element_size() + B * 24
    return 1e3 * nbytes / HBM_BYTES_PER_S


def case_matrices(H: int, W: int, B: int, dev) -> torch.Tensor:
    """(B, 2, 3) matrices of the first B unit-test cases about the centre
    of an H×W image."""
    from ppn_tpu_torch.ops.image import make_affine

    c = torch.tensor([W / 2.0, H / 2.0], device=dev)
    a, s, t, f = zip(*WARP_CASES[:B])
    return make_affine(
        c, c, torch.tensor(a, device=dev), torch.tensor(s, device=dev),
        torch.tensor([[x, -x] for x in t], device=dev),
        torch.tensor(f, device=dev))[0]


def warp_matrices(cfg, B: int, dev, seed: int) -> torch.Tensor:
    """(B, 2, 3) matrices: the six test cases first, then draws of
    ``sample_params`` on the card for random person boxes."""
    from ppn_tpu_torch.ops.augment import sample_params

    H, W = cfg.model.insize
    cases = case_matrices(H, W, len(WARP_CASES), dev)
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
    from ppn_tpu_torch.eval.runner import evaluate_oks, evaluate_pckh
    from ppn_tpu_torch.inference import Predictor, fetch_async, wait_host
    from ppn_tpu_torch.ops import cuda_build, cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import (affine_warp_separable_plain,
                                         resize_bilinear)
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import (KINDS, feature_map_case,
                                       nan_window_case)
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
    cases = [(name, B, kind) for name, B in (
        ("tiny_test", 3), ("mpii_r18_384", 1), ("mpii_r18_384", 8),
        ("mpii_r18_384", 128), ("coco_r18_384_crowded", 128))
        for kind in KINDS]
    cases += [("mpii_r18_384", 8, "empty"), ("mpii_r18_384", 8, "chain"),
              ("coco_r18_384_crowded", 8, "chain"),
              ("mpii_r18_384", 133, "normal")]
    worst_ulp, worst_err = 0, 0.0
    for name, B, kind in cases:
        m = get_config(name).model
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
    for name in ("tiny_test", "mpii_r18_384", "coco_r18_384_crowded"):
        m = get_config(name).model
        fm = torch.from_numpy(nan_window_case(m)).to(dev)
        got = cuda_post.postprocess_batch_cuda(m, fm)
        want = postprocess_batch_plain(m, fm)
        torch.cuda.synchronize()
        equal, ulp, err = compare(got, want)
        d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
        cell, score = got.kp_cell[0, 0, d].tolist(), float(got.kp_score[0, 0, d])
        log(f"[kernel] {name} NaN window case: decisions_equal={equal} "
            f"max_ulp={ulp}; slot 0 class {d}: cell {cell} score {score}")
        if not equal or ulp > ULP_LIMIT or cell != [0, 0] or score != 0.0:
            raise AssertionError(f"kernel disagrees: {name} NaN window case")

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
    warp_cases = []
    for cfg_w, images in ((mpii, cache.data["image"][:32].float() / 255.0),
                          (tiny, tiny_img)):
        for B in (images.shape[0], len(WARP_CASES)):
            warp_cases.append((f"{cfg_w.name} B={B}", images[:B],
                               warp_matrices(cfg_w, B, dev, seed=B)))
    rng = np.random.default_rng(4)
    for H, W, C, B in ((64, 97, 3, 6), (64, 97, 1, 6), (64, 97, 4, 6),
                       (384, 384, 3, 1)):   # widths no tile divides, C, B
        pixels = rng.random((B, H, W, C), np.float32)
        warp_cases.append((f"edge {H}x{W}x{C} B={B}",
                           torch.from_numpy(pixels).to(dev),
                           case_matrices(H, W, B, dev)))
    warp_err, warp_pixels = 0.0, 0
    for label, images, mats in warp_cases:
        for dt in (torch.bfloat16, torch.float32):
            x = images.to(dt)
            got = cuda_warp.affine_warp_cuda(x, mats)
            want = affine_warp_separable_plain(x, mats)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            n_diff = int((d > 0).sum())
            warp_err = max(warp_err, float(d.max()))
            warp_pixels += d.numel()
            log(f"[warp] {label} {str(dt)[6:]}: differing values {n_diff} "
                f"of {d.numel()}, max_abs_err {float(d.max()):.3g}")
            if n_diff:
                raise AssertionError(f"ppn_warp_kernel differs from its "
                                     f"plain version: {label} {dt}")

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
    times, post_stages = {}, {}
    for b, fm in ((1, fm1), (B, fm128)):
        call = functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
        k_ms, eager_ms = graph_ms(call, 50), time_ms(call, 50)
        call_us = host_us(call, 200)
        p_ms = time_ms(lambda: postprocess_batch_plain(m, fm), 5)
        bound, whole = kernel_bound_ms(m, fm), whole_map_bound_ms(m, b)
        times[b] = (k_ms, p_ms, bound, whole, eager_ms, call_us)
        log(f"[time] B={b}: ppn_post_kernel {k_ms:.4f} ms (CUDA graph of 50 "
            f"launches; back to back through the wrapper {eager_ms:.4f} ms, "
            f"the wrapper's host time {call_us:.1f} µs a call), plain "
            f"{p_ms:.3f} ms, bound {bound:.6f} ms (bytes this map needs; "
            f"whole map {whole:.6f} ms) | {card}")
    for kind, maps in (("main", {1: fm1, B: fm128}), ("normal", {
            b: torch.from_numpy(feature_map_case(m, b, seed=b)).to(dev)
            for b in (1, B)})):
        for b, fm in maps.items():
            us, span = post_stage_us(m, fm, 20)
            post_stages[kind, b] = dict(us, span=span)
            log(f"[stages] {kind} map B={b}: "
                + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
                + f" µs (sum {sum(us.values()):.3f}; mean over CTAs and "
                f"20 launches); launch span {span:.3f} µs | {card}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: pred.model(x), 10)
    log(f"[time] B={B}: model forward {fwd_ms:.3f} ms | {card}")
    del fm128, x

    # ---- 7. flip-TTA: PCKh through the kernel, B=128 throughput -------------
    tpred = Predictor.from_npz(cfg, SNAPSHOT, flip_tta=True)
    tcalls = 0

    def tpredict(images):
        nonlocal tcalls
        tcalls += 1
        return tpred.predict(images)

    cuda_post.LAUNCHES = 0
    summary = evaluate_pckh(cfg, tpredict, val, max_images=16, batch_size=8)
    tta_launches = cuda_post.LAUNCHES
    tta_pckh, tta_joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[tta] flip-TTA PCKh {tta_pckh:.5f} over {tta_joints:.0f} joints "
        f"(pinned {PINNED_TTA_PCKH} over {PINNED_JOINTS}); ppn_post_kernel "
        f"launches {tta_launches} over {tcalls} predict calls")
    if (abs(tta_pckh - PINNED_TTA_PCKH) >= 3e-3
            or tta_joints != PINNED_JOINTS or tta_launches != tcalls):
        raise AssertionError(f"flip-TTA PCKh {tta_pckh} / {tta_joints} "
                             f"joints, {tta_launches} launches in {tcalls} "
                             "calls")
    for _ in range(3):
        tpred.predict(images)
    tta_ms = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tpred.predict(images)
        end.record()
        torch.cuda.synchronize()
        tta_ms.append(start.elapsed_time(end))
    tta_med = statistics.median(tta_ms)
    log(f"[tta] B={B} TTA predict: median {tta_med:.3f} ms over "
        f"{len(tta_ms)} calls (min {min(tta_ms):.3f}, max {max(tta_ms):.3f})"
        f" = {1e3 * B / tta_med:.1f} img/s (without TTA {1e3 * B / med:.1f}"
        f") | {card}")

    # ---- 8. evaluation: COCO OKS AP through the kernel, the evaluate CLI ----
    from ppn_tpu_torch.apps import evaluate

    evaluation = {}
    for label, (name, snap, persons, thresholds, tta, pin,
                n_gt) in OKS_PINS.items():
        ecfg = get_config(name)
        if thresholds is not None:
            ecfg = dataclasses.replace(ecfg, model=dataclasses.replace(
                ecfg.model, detection_thresh=thresholds[0],
                nms_thresh=thresholds[1]))
        epred = Predictor.from_npz(ecfg, snap, flip_tta=tta)
        eval_set = heldout_dataset(ecfg, num_persons=persons)
        in_predict = []

        def timed_predict(images):
            t0 = time.perf_counter()
            out = epred.predict(images)
            in_predict.append(time.perf_counter() - t0)
            return out

        cuda_post.LAUNCHES = 0
        t0 = time.perf_counter()
        summary = evaluate_oks(ecfg, timed_predict, eval_set, max_images=16,
                               batch_size=8)
        first_s, e_launches = time.perf_counter() - t0, cuda_post.LAUNCHES
        in_predict.clear()          # again, warm: cuDNN set up, images cached
        t0 = time.perf_counter()
        again = evaluate_oks(ecfg, timed_predict, eval_set, max_images=16,
                             batch_size=8)
        warm_s = time.perf_counter() - t0
        evaluation[label] = dict(
            summary, launches=e_launches, pinned_ap=pin,
            repeat_equal=again == summary,
            first_ms_per_image=1e3 * first_s / 16,
            ms_per_image=1e3 * warm_s / 16,
            predict_ms_per_image=1e3 * sum(in_predict) / 16)
        log(f"[eval] {label}: OKS AP {summary['oks/AP']:.6f} (pinned {pin} "
            f"± {OKS_TOLERANCE}), AP50 {summary['oks/AP50']:.6f}, AP75 "
            f"{summary['oks/AP75']:.6f}, {summary['oks/num_gt']:.0f} GT; "
            f"ppn_post_kernel launches {e_launches} for 2 batches of 8; wall "
            f"{1e3 * warm_s / 16:.3f} ms per image warm ("
            f"{1e3 * sum(in_predict) / 16:.3f} in predict, the rest "
            f"batching and OKS matching on the host), {1e3 * first_s / 16:.3f}"
            f" ms cold | {card}")
        if (abs(summary["oks/AP"] - pin) >= OKS_TOLERANCE
                or summary["oks/num_gt"] != n_gt or e_launches != 2):
            raise AssertionError(f"OKS evaluation {label}: {summary}, "
                                 f"{e_launches} launches")
        del epred
    # the CLI, with the thresholds as flags and from a config.ini
    want = {k: round(v, 4) for k, v in evaluation["coco"].items()
            if k.startswith("oks/")}
    argv = ["--config", "coco_r18_384", "--ckpt-dir", COCO_SNAPSHOT,
            "--metric", "oks", "--num-persons", "2", "--max-images", "16",
            "--batch-size", "8"]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        ini = os.path.join(d, "config.ini")
        with open(ini, "w") as fh:
            fh.write("[model]\ndetection_thresh = 0.02\nthresh = 0.6\n")
        for label, extra in (("flags", ["--detection-thresh", "0.02",
                                        "--nms-thresh", "0.6"]),
                             ("ini", ["--ini", ini])):
            cuda_post.LAUNCHES = 0
            returned, printed = quiet_call(evaluate.main, argv + extra)
            got = json.loads(printed)
            evaluation[f"cli_{label}"] = dict(got, launches=cuda_post.LAUNCHES)
            log(f"[eval] evaluate CLI, thresholds from {label}: {got}; "
                f"ppn_post_kernel launches {cuda_post.LAUNCHES}")
            if got != want or returned != want or cuda_post.LAUNCHES != 2:
                raise AssertionError(f"evaluate CLI ({label}) printed {got},"
                                     f" the library {want}")

    # ---- 9. B=1 latency -----------------------------------------------------
    one = images[0]
    latency = {}
    for label, p_ in (("plain", pred), ("tta", tpred)):
        for _ in range(10):
            p_.predict_single(one)
        cuda_post.LAUNCHES = 0
        p50, p90 = percentiles_ms(lambda: p_.predict_single(one),
                                  LATENCY_CALLS)
        latency[label] = {"p50_ms": p50, "p90_ms": p90,
                          "launches": cuda_post.LAUNCHES}
        log(f"[b1] predict_single, {label}: p50 {p50:.3f} ms, p90 "
            f"{p90:.3f} ms over {LATENCY_CALLS} calls; ppn_post_kernel "
            f"launches {cuda_post.LAUNCHES} | {card}")
        if cuda_post.LAUNCHES != LATENCY_CALLS:
            raise AssertionError(f"{cuda_post.LAUNCHES} post launches in "
                                 f"{LATENCY_CALLS} B=1 calls")
    x1_host = torch.from_numpy(one[None])
    x1 = x1_host.to(dev)
    with torch.no_grad():
        split = {"h2d": events_ms(lambda: x1_host.to(dev), 50),
                 "forward": events_ms(lambda: pred.model(x1), 50)}
        fm1 = pred.model(x1)
    call1 = functools.partial(cuda_post.postprocess_batch_cuda, m, fm1)
    split["post_kernel_device"] = graph_ms(call1, 50)
    split["post_wrapper_host_us"] = host_us(call1, 200)
    split["post_eager"] = events_ms(call1, 50)
    ppl1 = call1()
    split["d2h"] = events_ms(lambda: wait_host(*fetch_async(ppl1)), 50)
    log("[b1] split of one B=1 call (median CUDA-event ms of 50; the "
        "kernel's as a CUDA-graph replay; the wrapper's host µs): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" | {card}")

    # ---- 10. server: micro-batched requests, verified bitwise ---------------
    from ppn_tpu_torch.apps import serve, video

    requests, max_batch = 64, 32
    cuda_post.LAUNCHES = 0
    rc, printed = quiet_call(serve.main, [
        "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--selftest",
        str(requests), "--threads", "8", "--max-batch", str(max_batch),
        "--window-ms", "5", "--json"])
    serve_launches = cuda_post.LAUNCHES
    server = json.loads(printed.strip().splitlines()[-1])
    # one launch per predict call: the warm-up runs each bucket 1..max_batch
    # for uint8 and f32, the server one per batch, and the self-test's
    # check one per chunk of the requests at each bucket it saw
    warm = 2 * max_batch.bit_length()
    served = sum(server["batches_by_size"].values())
    direct = sum(-(-requests // int(b)) for b in server["batches_by_size"])
    server["launches"] = served
    log(f"[serve] {json.dumps(server)} | {card}")
    log(f"[serve] ppn_post_kernel launches {serve_launches} = {warm} "
        f"warm-up + {served} batches served + {direct} direct predicts of "
        "the check")
    if (rc != 0 or server["mismatches"] != 0
            or serve_launches != warm + served + direct):
        raise AssertionError(f"server self-test failed: rc {rc}, "
                             f"{serve_launches} launches, {server}")

    # ---- 11. video: 720p frames, on-device resize ---------------------------
    vcfg = get_config("mpii_r18_384")    # the video app's thresholds
    frame0 = next(video.synthetic_frames(1, fps=0))
    got = video.make_video_pipeline(vcfg, pred.model)(frame0)
    with torch.no_grad():
        img = resize_bilinear(torch.from_numpy(frame0).to(dev).float() / 255.0,
                              vcfg.model.insize)
        want = postprocess_batch_plain(vcfg.model, pred.model(img[None]))
    want = type(want)(*(t[0] for t in want))
    equal, ulp, err = compare(got, want)
    log(f"[video] first 720p frame through the pipeline against the plain "
        f"pipeline: decisions_equal={equal} max_ulp={ulp} persons "
        f"{int(want.valid.sum())}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("video pipeline disagrees with the plain one")
    videos = {}
    for label, extra in (("overlap", []), ("no_overlap", ["--no-overlap"])):
        cuda_post.LAUNCHES = 0
        summary_v, _ = quiet_call(video.main, [
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            "synthetic", "--frames", str(VIDEO_FRAMES), "--json", *extra])
        summary_v["launches"] = cuda_post.LAUNCHES
        videos[label] = summary_v
        log(f"[video] {label}: {json.dumps(summary_v)} (launches include "
            f"the warm-up frame) | {card}")
        if summary_v["launches"] != summary_v["frames"] + 1:
            raise AssertionError(f"video: {summary_v['launches']} post "
                                 f"launches for {summary_v['frames']} frames"
                                 " and the warm-up")
    del pred, tpred, fm1

    # ---- 12. one train step on the card against the CPU ---------------------
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

    # ---- 13. training path: fine-tune at full width, resume, evaluate -------
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

        # ---- 14. training times ---------------------------------------------
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

    # ---- 15. overfit 8 fixed images from a fresh init -----------------------
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

    # ---- 16. warp kernel times at the training path's shape -----------------
    xw = cache.data["image"][:32].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    mw = warp_matrices(mpii, 32, dev, seed=32)
    wcall = functools.partial(cuda_warp.affine_warp_cuda, xw, mw)
    w_ms, w_eager_ms = graph_ms(wcall, 50), time_ms(wcall, 50)
    wp_ms = time_ms(lambda: affine_warp_separable_plain(xw, mw), 5)
    w_bound = warp_bound_ms(xw)
    log(f"[time] B=32 384x384x3 bf16: ppn_warp_kernel {w_ms:.4f} ms (CUDA "
        f"graph of 50 launches; back to back {w_eager_ms:.4f} ms), plain "
        f"{wp_ms:.3f} ms, bound {w_bound:.6f} ms (bytes) | {card}")

    # ---- 17. report ---------------------------------------------------------
    k_ms, p_ms, bound, whole, eager_ms, call_us = times[B]
    k1_ms, p1_ms, bound1, whole1, eager1_ms, call1_us = times[1]
    log(json.dumps({"serving_slice": {
        "tta_pckh": tta_pckh, "tta_joints": tta_joints,
        "tta_launches": tta_launches, "tta_predict_calls": tcalls,
        "tta_predict_ms_b128": tta_med, "tta_img_per_s_b128": 1e3 * B / tta_med,
        "b1_latency": latency, "b1_split_ms": split, "server": server,
        "video": videos}}))
    log(json.dumps({"evaluation_slice": evaluation}))
    log(card)   # the nvidia-smi name,power.limit line, as it prints it
    log(json.dumps({"kernels": [{
        "name": "ppn_post_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/post.cu",
        "replaces": "ppn_tpu/ops/pallas_post_packed.py:584",
        "also_replaces": "ppn_tpu/ops/pallas_post.py:292",
        "launches": launches, "max_abs_err": worst_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "ms_by": "CUDA graph replay of 50 launches",
        "ms_eager": eager_ms, "ms_eager_b1": eager1_ms,
        "host_us_per_call": call_us, "host_us_per_call_b1": call1_us,
        "bound_held_to": "bytes the main-path map needs",
        "bound_ms_whole_map": whole,
        "decisions_equal": True, "max_ulp": worst_ulp,
        "batch": B, "ms_b1": k1_ms, "plain_ms_b1": p1_ms,
        "bound_ms_b1": bound1, "bound_ms_b1_whole_map": whole1,
        "stage_us_b1": post_stages["main", 1],
        "stage_us_b128": post_stages["main", B],
        "stage_us_normal_b1": post_stages["normal", 1],
        "stage_us_normal_b128": post_stages["normal", B],
        "predict_ms_b128": med,
        "img_per_s_b128": 1e3 * B / med, "forward_ms_b128": fwd_ms,
        "launches_training_path": post_train_launches,
        "launches_evaluation_path": sum(
            v["launches"] for v in evaluation.values()),
    }, {
        "name": "ppn_warp_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/warp.cu",
        "replaces": "ppn_tpu/ops/pallas_warp.py:166",
        "launches": warp_launches, "max_abs_err": warp_err,
        "ms": w_ms, "plain_ms": wp_ms, "bound_ms": w_bound,
        "bound_by": "bytes", "library_ms": None,
        "bound_held_to": "each input pixel read once, each output written once",
        "ms_by": "CUDA graph replay of 50 launches", "ms_eager": w_eager_ms,
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
