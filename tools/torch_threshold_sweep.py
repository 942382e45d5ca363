"""Sweep post-process operating points (detection/NMS thresholds) of a
trained checkpoint, on the port.

The model forward runs once over the validation set, and its feature maps
stay on ``--device``; each (det, nms) point then re-runs only the
post-process over them, in one call (one ``ppn_post_kernel`` launch on a
GPU). The flags, the printed lines and the JSON keys are those of
tools/threshold_sweep.py, with ``--device`` added. ``--ckpt-dir`` is an
inference snapshot (``.npz``) or a directory of the port's own checkpoints
(``ckpt_*.pt``, read by ``train/checkpoint.load_state``; the EMA
parameters when tracked).

    python tools/torch_threshold_sweep.py --ckpt-dir CKPT_OR_NPZ \
        [--num-persons 2] [--det 0.1,0.15,0.2] [--nms 0.3,0.45] \
        [--flip-tta] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@torch.no_grad()
def forward_once(cfg, model, val, batch_size: int, flip_tta: bool, device):
    """The f32 feature maps of every image of ``val`` (on ``device``) and
    the collated GT (host numpy): the forward in fixed-size batches, the
    last one padded (``pad_batch``), padded rows dropped."""
    from ppn_tpu_torch.data.pipeline import epoch_batches
    from ppn_tpu_torch.eval.runner import pad_batch
    from ppn_tpu_torch.ops.tta import flip_tta_forward

    fms, gts = [], []
    for batch in epoch_batches(val, batch_size, rng=np.random.default_rng(0),
                               shuffle=False, drop_remainder=False):
        batch, n_real = pad_batch(batch, batch_size)
        x = torch.from_numpy(batch["image"]).to(device)
        fm = (flip_tta_forward(cfg.model, model, x) if flip_tta
              else model(x))
        fms.append(fm.float()[:n_real])
        gts.append({k: v[:n_real] for k, v in batch.items()})
    gt = {k: np.concatenate([g[k] for g in gts]) for k in gts[0]}
    return torch.cat(fms), gt


def sweep_point(cfg, fms, gt, det: float, nms: float) -> dict:
    """PCKh summary of the cached maps at one (det, nms) point: one call of
    the post-process on the maps' device."""
    from ppn_tpu_torch.eval.pckh import PCKhEvaluator
    from ppn_tpu_torch.eval.runner import add_pckh_batch
    from ppn_tpu_torch.inference import fetch_async, wait_host
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_fast

    m = dataclasses.replace(cfg.model, detection_thresh=det, nms_thresh=nms)
    people = wait_host(*fetch_async(postprocess_batch_fast(m, fms)))
    ev = PCKhEvaluator(m)
    add_pckh_batch(ev, people, gt, fms.shape[0])
    return ev.summarize()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--num-persons", type=int, default=2)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--det", default="0.10,0.15,0.20")
    p.add_argument("--nms", default="0.30,0.45")
    p.add_argument("--flip-tta", action="store_true")
    p.add_argument("--per-joint", action="store_true",
                   help="print the best point's full per-joint PCKh dict")
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward and the post-process")
    args = p.parse_args(argv)

    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.train.checkpoint import load_state
    from ppn_tpu_torch.train.steps import eval_model

    base = get_config(args.config)
    val = SyntheticPoseDataset(base, size=args.size, seed=10_000,
                               cache=True, num_persons=args.num_persons)
    if args.ckpt_dir.endswith(".npz"):
        model = Predictor.from_npz(base, args.ckpt_dir,
                                   device=args.device).model
        print(f"loaded inference snapshot {args.ckpt_dir}")
    else:
        # restored with an EMA tracked, a checkpoint's saved EMA is kept as
        # the eval parameters (one without seeds it from its parameters),
        # as the JAX tool's load_state keeps a saved EMA
        tracked = dataclasses.replace(base, train=dataclasses.replace(
            base.train, ema_decay=base.train.ema_decay or 0.999))
        model = eval_model(load_state(tracked, args.ckpt_dir,
                                      device=args.device))
    fms, gt = forward_once(base, model, val, args.batch_size, args.flip_tta,
                           next(model.parameters()).device)

    best = None
    for det in (float(x) for x in args.det.split(",")):
        for nms in (float(x) for x in args.nms.split(",")):
            summ = sweep_point(base, fms, gt, det, nms)
            rec = {"det": det, "nms": nms,
                   "pckh_mean": round(summ["pckh/mean"], 4)}
            print(json.dumps(rec))
            if best is None or rec["pckh_mean"] > best["pckh_mean"]:
                best = rec
                best_summ = summ
    print("best:", json.dumps(best))
    if args.per_joint:
        print("per_joint:", json.dumps(
            {k: round(v, 4) for k, v in best_summ.items()}))


if __name__ == "__main__":
    main()
