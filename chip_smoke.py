#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``ppn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device  — require CUDA; print the card's name and power limit; turn
               TF32 off for matmuls and cuDNN convs;
  2. build   — compile ``ppn_post_kernel`` (ppn_tpu_torch/csrc/post.cu) with
               nvcc for sm_90a;
  3. kernel  — the kernel against its plain PyTorch version on the card:
               tiny_test, mpii_r18_384 at B=1, 8, 128 and coco_r18_384_crowded
               at B=128; every decision field bitwise equal, float fields
               within 4 ulps;
  4. main path, part 1 — ``Predictor.from_npz`` on the committed MPII
               snapshot, PCKh over the 16-image synthetic protocol at B=8
               (det 0.02, nms 0.45): 0.9921 ± 3e-3 over 378 joints;
  5. main path, part 2 — uint8 (128, 384, 384, 3) through
               ``Predictor.predict``: warm-up, then the median of 20 calls
               timed with CUDA events; the kernel's own time beside its
               plain version's and its bound;
  6. report  — the kernels line, then the device line last.

The launch counts are set to 0 just before phase 4 and read just after
phase 5; comparison and timing launches fall outside that window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
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
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def main() -> int:
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import heldout_dataset
    from ppn_tpu_torch.eval.runner import evaluate_pckh
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import KINDS, feature_map_case

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
    report = cuda_post.build(force=True)
    log(f"[build] ppn_post_kernel built in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---- 3. kernel against plain on the card --------------------------------
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

    # ---- 4. main path: snapshot PCKh through the kernel ---------------------
    cfg = get_config("mpii_r18_384")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=0.02, nms_thresh=0.45))
    pred = Predictor.from_npz(
        cfg, os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz"))
    val = heldout_dataset(cfg, num_persons=2)
    calls = 0

    def predict(images):
        nonlocal calls
        calls += 1
        return pred.predict(images)

    cuda_post.LAUNCHES = 0
    t0 = time.perf_counter()
    summary = evaluate_pckh(cfg, predict, val, max_images=16, batch_size=8)
    pckh, joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[main] PCKh {pckh:.4f} over {joints:.0f} joints "
        f"({time.perf_counter() - t0:.1f} s, {calls} predict calls)")
    if abs(pckh - PINNED_PCKH) >= 3e-3 or joints != PINNED_JOINTS:
        raise AssertionError(f"PCKh {pckh} / {joints} joints, pinned "
                             f"{PINNED_PCKH} / {PINNED_JOINTS}")

    # ---- 5. main path at full width: B=128 uint8 through predict ------------
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
        f"calls")
    if launches == 0 or launches != calls:
        raise AssertionError(f"{launches} kernel launches for {calls} calls")

    # ---- kernel times at the main path's shapes -----------------------------
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

    # ---- 6. report ----------------------------------------------------------
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
        "img_per_s_b128": 1e3 * B / med, "forward_ms_b128": fwd_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
