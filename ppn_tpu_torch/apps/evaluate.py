"""Evaluation CLI (port of ``ppn_tpu/apps/evaluate.py``): PCKh@0.5 or COCO
OKS AP over the held-out validation split, the same flags plus
``--device``.

Loads weights through ``Predictor.from_checkpoint`` (an inference snapshot
``.npz``, the newest of the port's own checkpoints in a directory, or a
fresh init) and scores ``Predictor.predict``'s People batch by batch: one
``ppn_post_kernel`` launch per batch on the card. Prints the summary as
JSON on stdout.

    python -m ppn_tpu_torch.apps.evaluate --config coco_r18_384 \
        --ckpt-dir artifacts/coco_hero_r3_ema_f16.npz --metric oks \
        --num-persons 2 --max-images 16 --batch-size 8 \
        --detection-thresh 0.02 --nms-thresh 0.6

``--data mpii|coco`` scores the validation split of a dataset tree under
``--data-root`` (``apps/train.make_datasets``: ``data/mpii.py`` or
``data/coco.py``: JPEGs decoded natively, other files through PIL); a tree
without one exits with a message:

    python -m ppn_tpu_torch.apps.evaluate --config mpii_r18_384 \
        --data mpii --data-root /data/mpii \
        --ckpt-dir artifacts/mpii_hero_r5_ema_f16.npz --batch-size 8
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="PPN PCKh / OKS evaluation")
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ini", default=None, metavar="PATH",
                   help="reference-style config.ini applied over --config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "mpii", "coco"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--max-images", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-persons", type=int, default=None,
                   help="synthetic data: fixed persons per image (default: "
                        "random 1..max_persons) — match the training eval "
                        "protocol")
    p.add_argument("--metric", default="pckh", choices=["pckh", "oks"],
                   help="pckh = MPII PCKh@0.5; oks = COCO-style OKS "
                        "AP/AP50/AP75")
    p.add_argument("--flip-tta", action="store_true",
                   help="horizontal-flip test-time augmentation: merge the "
                        "mirrored prediction in logit space (ops/tta.py)")
    p.add_argument("--detection-thresh", type=float, default=None,
                   help="shorthand for --set model.detection_thresh=X")
    p.add_argument("--nms-thresh", type=float, default=None,
                   help="shorthand for --set model.nms_thresh=X")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="PATH=VALUE",
                   help="dotted-path config override, applied after all "
                        "other flags (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    from ppn_tpu_torch.configs import resolve_config

    cfg = resolve_config(args.config, args.ini)
    # shorthand flags first, generic --set last
    overrides = []
    if args.detection_thresh is not None:
        overrides.append(f"model.detection_thresh={args.detection_thresh}")
    if args.nms_thresh is not None:
        overrides.append(f"model.nms_thresh={args.nms_thresh}")
    overrides += list(args.overrides)
    if overrides:
        from ppn_tpu_torch.overrides import apply_overrides

        cfg = apply_overrides(cfg, overrides)
    from ppn_tpu_torch.apps.train import make_datasets
    from ppn_tpu_torch.eval.runner import evaluate_oks, evaluate_pckh
    from ppn_tpu_torch.inference import Predictor

    class _A:
        data = args.data
        data_root = args.data_root
        overfit = None
        num_persons = args.num_persons
        train_size = 1  # only the val split is used; keep train-gen trivial

    _, val = make_datasets(cfg, _A)
    if val is None:
        raise SystemExit("no validation split available")
    predictor = Predictor.from_checkpoint(cfg, args.ckpt_dir,
                                          flip_tta=args.flip_tta,
                                          device=args.device)
    if args.ckpt_dir:
        print(f"loaded {args.ckpt_dir}", file=sys.stderr)
    evaluate = evaluate_pckh if args.metric == "pckh" else evaluate_oks
    summary = evaluate(cfg, predictor.predict, val,
                       max_images=args.max_images,
                       batch_size=args.batch_size)
    summary = {k: round(v, 4) for k, v in summary.items()}
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
