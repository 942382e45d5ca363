"""Where the time of the port's batched predict goes, on one NVIDIA GPU.

Drives ``ppn_tpu_torch.inference.Predictor.predict`` on uint8
(B, 384, 384, 3) images with the committed MPII snapshot and reports:

  * stages, each timed alone with CUDA events (median of --reps):
    h2d (pageable uint8 upload), forward (normalize + trunk + head),
    post (ppn_post_kernel), d2h (People download), and predict end to end;
  * a torch.profiler window over --reps predict calls: device time per
    kernel category (conv, elementwise, copy, ppn_post_kernel, other),
    the top kernels, and the device's busy and idle share of the window.

    python tools/torch_predict_profile.py [--batch 128] [--reps 10] [--out F]

Imports nothing of JAX; needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _category(name: str) -> str:
    n = name.lower()
    if "ppn_post_kernel" in n:
        return "ppn_post_kernel"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "sm90_", "implicit")):
        return "conv"
    if "elementwise" in n or "vectorized" in n or "reduce" in n or "pool" in n:
        return "elementwise"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_predict_profile: no CUDA device", file=sys.stderr)
        return 2

    from chip.timing import events_ms, smi_line
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops.cuda_post import postprocess_batch_cuda

    card = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mpii_r18_384")
    pred = Predictor.from_npz(
        cfg, os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz"))
    dev, m, B = pred.device, cfg.model, args.batch
    images = np.random.default_rng(args.seed).integers(
        0, 256, (B, *m.insize, 3), dtype=np.uint8)
    for _ in range(3):
        pred.predict(images)

    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        fm = pred.model(x)
        ppl = postprocess_batch_cuda(m, fm)
        stages = {
            "h2d": events_ms(lambda: torch.from_numpy(images).to(dev),
                             args.reps),
            "forward": events_ms(lambda: pred.model(x), args.reps),
            "post": events_ms(lambda: postprocess_batch_cuda(m, fm),
                              args.reps),
            "d2h": events_ms(lambda: [t.cpu() for t in ppl], args.reps),
            "predict": events_ms(lambda: pred.predict(images), args.reps),
        }
    stages["sum_of_stages"] = sum(v for k, v in stages.items()
                                  if k != "predict")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            pred.predict(images)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, by_name = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_us = sum(by_cat.values())
    if events:
        t0 = min(e.time_range.start for e in events)
        t1 = max(e.time_range.end for e in events)
        window_us = t1 - t0
    else:
        window_us = 0.0
    per_call = {k: v / 1e3 / args.reps for k, v in sorted(by_cat.items())}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    result = {
        "card": card, "batch": B, "reps": args.reps,
        "stage_ms": stages,
        "img_per_s": 1e3 * B / stages["predict"],
        "profile_device_ms_per_call": per_call,
        "profile_busy_ms_per_call": busy_us / 1e3 / args.reps,
        "profile_window_ms_per_call": window_us / 1e3 / args.reps,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us else None,
        "top_kernels_ms_per_call": [
            (name[:90], us / 1e3 / args.reps) for name, us in top],
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
