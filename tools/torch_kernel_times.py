"""Times the port's two CUDA kernels at the main paths' shapes, on one
NVIDIA GPU, for the checkout given by --tree (default: this one).

    python tools/torch_kernel_times.py [--tree DIR] [--reps 50] [--out F]

``ppn_tpu_torch`` is imported from DIR, so two checkouts (a parent commit's
package unpacked with ``git archive`` into a directory ``.gitignore``
lists, and this one) can be timed in turns on one card: parent, change,
change, parent. The snapshot, the timers (``chip/timing.py``) and the warp
inputs (``chip/kernels.warp_matrices``) come from this checkout, imported
before DIR goes on the path. The inputs are those of ``chip_smoke.py``:

  * ``ppn_post_kernel`` at B=1 and B=128 on the main-path map (the committed
    MPII snapshot's output on seeded uint8 images, phase 6) and on the
    ``normal`` map (phase 3);
  * ``ppn_warp_kernel`` at B=32, 384×384×3 bf16, on 32 synthetic images and
    the phase-17 matrices (the six unit-test cases, then drawn crops).

``ms`` is a CUDA-event mean over --reps launches replayed from a CUDA
graph: the kernel and its launch without the host's per-call Python work
(null where the wrapper cannot be captured). ``eager_ms`` times --reps
calls back to back through the wrapper, and ``host_us`` is the wrapper's
host time per call. Prints one JSON line (also written to --out) with the
card's ``nvidia-smi`` name and power limit. Imports nothing of JAX; fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's inputs and timers, imported before DIR's package
    from chip.kernels import warp_matrices
    from chip.timing import graph_ms, host_us, smi_line, time_ms

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.testing import feature_map_case

    if not cuda_post.__file__.startswith(tree):
        raise RuntimeError(f"imported {cuda_post.__file__}, not from {tree}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mpii_r18_384")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=0.02, nms_thresh=0.45))
    m = cfg.model
    pred = Predictor.from_npz(
        cfg, os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz"))
    images = np.random.default_rng(0).integers(
        0, 256, (128, *m.insize, 3), dtype=np.uint8)
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        maps = {"main_b1": pred.model(x[:1]), "main_b128": pred.model(x)}
    del pred, x
    for b in (1, 128):
        maps[f"normal_b{b}"] = torch.from_numpy(
            feature_map_case(m, b, seed=b)).to(dev)
    calls = {k: functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
             for k, fm in maps.items()}

    ds = SyntheticPoseDataset(cfg, size=32, seed=0)
    xw = torch.from_numpy(np.stack([ds[i]["image"] for i in range(32)])).to(
        dev).float().div(255.0).to(torch.bfloat16)
    mw = warp_matrices(cfg, 32, dev, seed=32)
    calls["warp_b32_bf16"] = functools.partial(cuda_warp.affine_warp_cuda,
                                               xw, mw)
    # eager times first: a wrapper that cannot be captured (an older one
    # may set a function attribute at every launch) then loses only its
    # graph times
    eager = {k: time_ms(c, args.reps) for k, c in calls.items()}
    host = {k: host_us(c, 4 * args.reps) for k, c in calls.items()}
    graph = {}
    for k, c in calls.items():
        try:
            graph[k] = graph_ms(c, args.reps)
        except RuntimeError as err:
            graph[k] = None
            print(f"torch_kernel_times: no graph time for {k}: {err}",
                  file=sys.stderr)
    line = json.dumps({"tree": tree, "card": smi_line(),
                       "reps": args.reps, "ms": graph, "eager_ms": eager,
                       "host_us": host})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
