"""Times the video CLI on a directory of JPEGs (``apps/video.main --source
<dir>``) on one NVIDIA GPU, for the checkout given by --tree (default: this
one).

    python tools/torch_video_dir.py [--tree DIR] [--frames 128] [--runs 3]
                                    [--workers N] [--out F]

``ppn_tpu_torch`` is imported from DIR, so two checkouts (a parent commit's
package unpacked with ``git archive`` into a directory ``.gitignore``
lists, and this one) can be timed in turns on one card: parent, change,
change, parent. The inputs: the 16 held-out protocol images (seed 10 000,
two persons) written as quality-95 JPEGs at 384² and enlarged 2.5× to 960²
(PIL bilinear), streamed unpaced and cycled to --frames, through the MPII
snapshot. For each size the medians over --runs runs of the CLI's own
summary (frames processed, fps, p50 and p90 ms from frame in hand to poses
on the host). ``--workers N`` runs the native decode pool of a tree that
has one (``ppn_tpu_torch/native``) with N threads instead of the video
source's own count. Prints one JSON line (also appended to --out) with the card's
``nvidia-smi`` name and power limit. Imports nothing of JAX; fails without
a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")


def write_frames(d: str, scale: float) -> str:
    """The 16 protocol images as JPEGs under ``d``, enlarged by ``scale``."""
    from PIL import Image

    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import heldout_dataset

    held = heldout_dataset(get_config("mpii_r18_384"), num_persons=2)
    os.makedirs(d, exist_ok=True)
    for i in range(16):
        img = Image.fromarray(held[i]["image"])
        size = round(img.width * scale), round(img.height * scale)
        if scale != 1.0:
            img = img.resize(size, Image.BILINEAR)
        img.save(os.path.join(d, f"{i:05d}.jpg"), quality=95)
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_video_dir: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from ppn_tpu_torch.apps import video

    if args.workers:
        from ppn_tpu_torch.native import loader

        class Pool(loader.NativeJpegLoader):
            def __init__(self, out_size, num_workers=None):
                super().__init__(out_size, num_workers=args.workers)

        loader.NativeJpegLoader = Pool

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"tree": args.tree, "card": card, "frames_offered": args.frames,
              "workers": args.workers}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for label, scale in (("384", 1.0), ("960", 2.5)):
            frames = write_frames(os.path.join(d, label), scale)
            runs = []
            for _ in range(args.runs):
                with contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(io.StringIO()):
                    runs.append(video.main([
                        "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT,
                        "--source", frames, "--frames", str(args.frames),
                        "--json"]))
            result[label] = {k: statistics.median(r[k] for r in runs)
                             for k in runs[0]}
            result[label]["runs"] = runs
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
