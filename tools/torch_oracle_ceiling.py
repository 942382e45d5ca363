"""Compute the oracle parse ceiling for a synthetic val set, on the port.

Feeds GT-perfect feature maps (encode → targets_to_feature_map) through
the same post-process and PCKh evaluation used for model predictions: the
PCKh ceiling that PPN's parsing semantics impose (same-class NMS
suppression between nearby people, cross-person limb steals). The flags,
the printed lines and the numbers are those of tools/oracle_ceiling.py;
the maps are encoded on the host and post-processed in one call on
``--device`` (``ppn_post_kernel`` on a GPU, the plain version on the CPU).

    python tools/torch_oracle_ceiling.py [--num-persons 2] [--size 128] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def oracle_maps(m, samples):
    """(N, H', W', C) f32 CPU tensor: the GT-perfect map of each sample."""
    import torch

    from ppn_tpu_torch.ops import encode as enc

    return torch.stack([enc.targets_to_feature_map(m, enc.encode_single(
        m, s["keypoints"], s["visible"], s["bboxes"], s["valid"]))
        for s in samples])


def pckh_of_maps(m, fms, samples, device) -> dict:
    """PCKh summary of feature maps through the port's post-process on
    ``device``: one call (one kernel launch on a GPU) for the whole set."""
    from ppn_tpu_torch.eval.pckh import PCKhEvaluator
    from ppn_tpu_torch.eval.runner import synthetic_headsizes
    from ppn_tpu_torch.inference import fetch_async, wait_host
    from ppn_tpu_torch.ops.parse import People
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_fast

    ppl = wait_host(*fetch_async(postprocess_batch_fast(m, fms.to(device))))
    ev = PCKhEvaluator(m)
    for i, s in enumerate(samples):
        ev.add_image(People(*(x[i] for x in ppl)), s["keypoints"],
                     s["visible"], s["bboxes"], s["valid"],
                     synthetic_headsizes(s["bboxes"]))
    return ev.summarize()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--num-persons", type=int, default=2)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=10_000,
                   help="10000 = the train CLI's held-out val seed")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="PATH=VALUE",
                   help="dotted-path config override, e.g. "
                        "--set model.nms_thresh=0.6 (the ceiling depends "
                        "on the postprocess operating point)")
    p.add_argument("--per-joint", action="store_true",
                   help="print the full per-joint PCKh dict")
    p.add_argument("--device", default="cuda",
                   help="torch device of the post-process (cuda: the "
                        "CUDA kernel; cpu: its plain version)")
    args = p.parse_args(argv)

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.overrides:
        from ppn_tpu_torch.overrides import apply_overrides

        cfg = apply_overrides(cfg, args.overrides)
    m = cfg.model
    np_ = args.num_persons if args.num_persons > 0 else None  # 0 = random
    ds = SyntheticPoseDataset(cfg, size=args.size, seed=args.seed,
                              num_persons=np_)
    samples = [ds[i] for i in range(args.size)]
    summ = pckh_of_maps(m, oracle_maps(m, samples), samples, device)
    label = (f"{args.num_persons}-person" if np_ is not None
             else f"random-1..{cfg.data.max_persons}-person")
    print(f"oracle ceiling ({label}, {args.size} images, "
          f"seed {args.seed}): PCKh@0.5 mean = {summ['pckh/mean']:.4f}")
    if args.per_joint:
        import json

        print("per_joint:", json.dumps(
            {k: round(v, 4) for k, v in summ.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
