"""Crowded-scene parsing characterization, on the port.

For each crowding level (fixed persons-per-image protocols, plus the
random-1..max stress protocol) this computes, on the same held-out
synthetic scenes, what tools/crowding_study.py computes, under its flags,
printed lines and JSON keys, with ``--device`` added:

1. **collision bound** — a parser-independent upper bound on PCKh from
   grid-cell collisions alone (persons whose instance centers share a
   stride cell yield one proposal; same-class keypoints sharing a cell
   encode to one), with the kept candidates chosen optimally;
2. **oracle ceiling** — GT-perfect feature maps through the real
   decode/NMS/parse pipeline, per NMS operating point;
3. **model PCKh** — a snapshot through the same pipeline (optional,
   --snapshot), per operating point; the forward runs once per protocol
   and its feature maps stay on ``--device`` while the sweep re-runs only
   the post-process (one call per map set and point: one
   ``ppn_post_kernel`` launch on a GPU).

    python tools/torch_crowding_study.py \
        --snapshot artifacts/crowd_hero_r5_ema_f16.npz --out study.json \
        [--device cuda|cpu]
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


def collision_bound(m, ds, size):
    """Parser-independent PCKh upper bound from grid collisions (see the
    module docstring) over the first ``size`` samples of ``ds`` (a dataset
    or a list of samples). Returns (bound, lost_person_frac)."""
    from ppn_tpu_torch.eval.runner import synthetic_headsizes

    sy, sx = m.stride
    tot = 0
    credit = 0.0
    persons = 0
    lost_persons = 0
    for i in range(size):
        s = ds[i]
        idx = np.where(s["valid"])[0]
        kps, vis, bb = s["keypoints"], s["visible"], s["bboxes"]
        headsz = synthetic_headsizes(bb)
        persons += len(idx)
        tot += int(vis[idx].sum())

        # instance-cell groups: keep the member with the most visible
        # joints (optimal for the bound since lost persons credit 0)
        groups = {}
        for g in idx:
            cell = (int(bb[g, 1] // sy), int(bb[g, 0] // sx))
            groups.setdefault(cell, []).append(g)
        survivors = []
        for members in groups.values():
            keep = max(members, key=lambda g: int(vis[g].sum()))
            survivors.append(keep)
            lost_persons += len(members) - 1

        # per-class keypoint-cell groups among surviving persons
        for k in range(m.num_keypoints):
            cells = {}
            for g in survivors:
                if not vis[g, k]:
                    continue
                cell = (int(kps[g, k, 1] // sy), int(kps[g, k, 0] // sx))
                cells.setdefault(cell, []).append(g)
            for members in cells.values():
                if len(members) == 1:
                    credit += 1.0
                    continue
                best = 0
                for kept in members:  # optimal kept-joint choice
                    c = sum(
                        1 for g in members
                        if np.hypot(*(kps[g, k] - kps[kept, k]))
                        < 0.5 * max(headsz[g], 1e-6))
                    best = max(best, c)
                credit += best
    return credit / max(tot, 1), lost_persons / max(persons, 1)


@torch.no_grad()
def model_maps(model, samples, batch: int, device):
    """The model's f32 feature maps of the samples' images, forwarded
    ``batch`` at a time on ``device``; they stay there."""
    outs = []
    for s0 in range(0, len(samples), batch):
        imgs = np.stack([s["image"] for s in samples[s0:s0 + batch]])
        outs.append(model(torch.from_numpy(imgs).to(device)).float())
    return torch.cat(outs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="coco_r18_384")
    p.add_argument("--snapshot", default=None,
                   help="inference npz for model PCKh (else oracle-only)")
    p.add_argument("--protocols", default="1,2,3,4,5,6,0",
                   help="comma list of persons/image; 0 = random 1..max")
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--seed", type=int, default=10_000)
    p.add_argument("--det", type=float, default=0.02,
                   help="detection threshold for the model sweep (the "
                        "hero's best point; oracle scores are ~1.0 so det "
                        "does not bind there)")
    p.add_argument("--nms-grid", default="0.3,0.45,0.6")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward and the post-process")
    args = p.parse_args(argv)

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from tools.torch_oracle_ceiling import oracle_maps, pckh_of_maps

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    nms_grid = [float(x) for x in args.nms_grid.split(",")]

    model = None
    if args.snapshot:
        from ppn_tpu_torch.utils.params_io import load_inference_npz

        model = load_inference_npz(cfg, args.snapshot, device=device)

    results = []
    for proto in (int(x) for x in args.protocols.split(",")):
        np_ = proto if proto > 0 else None
        ds = SyntheticPoseDataset(cfg, size=args.size, seed=args.seed,
                                  num_persons=np_)
        label = (f"{proto}_person" if np_ else
                 f"random_1_to_{cfg.data.max_persons}")
        samples = [ds[i] for i in range(args.size)]   # rendered once
        bound, lost_frac = collision_bound(cfg.model, samples, args.size)

        # GT-perfect feature maps (oracle) — built once per protocol
        gt_fms = oracle_maps(cfg.model, samples).to(device)
        # model feature maps — forward once per protocol, kept on device
        fms = (None if model is None else
               model_maps(model, samples, args.batch_size, device))

        points = []
        for nms in nms_grid:
            m = dataclasses.replace(cfg.model, detection_thresh=args.det,
                                    nms_thresh=nms)
            ceiling = pckh_of_maps(m, gt_fms, samples, device)["pckh/mean"]
            rec = {"det": args.det, "nms": nms,
                   "oracle_ceiling": round(ceiling, 4)}
            if fms is not None:
                pckh = pckh_of_maps(m, fms, samples, device)["pckh/mean"]
                rec["model_pckh"] = round(pckh, 4)
                rec["model_over_ceiling"] = round(
                    pckh / max(ceiling, 1e-9), 4)
            points.append(rec)
            print(f"{label} nms={nms}: {rec}", flush=True)

        best = max(points, key=lambda r: r.get("model_pckh",
                                               r["oracle_ceiling"]))
        results.append({
            "protocol": label,
            "images": args.size,
            "collision_bound": round(bound, 4),
            "lost_person_frac": round(lost_frac, 4),
            "points": points,
            "best_point": best,
            "ceiling_over_bound": round(
                max(pt["oracle_ceiling"] for pt in points)
                / max(bound, 1e-9), 4),
        })
        print(f"{label}: bound={bound:.4f} best={best}", flush=True)

    out = {"config": args.config, "seed": args.seed,
           "snapshot": args.snapshot, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
