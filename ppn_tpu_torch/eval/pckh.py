"""MPII PCKh@0.5 evaluation (port of ``ppn_tpu/eval/pckh.py``).

A predicted joint is correct if it lies within ``0.5 · headsize`` of GT.
Predicted persons are greedily matched to GT persons by instance-box IoU in
descending instance-score order. Host-side numpy on the port's ``People``
(numpy fields, one image).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.parse import People


def headsize_from_bbox(head_bbox: np.ndarray, sc_bias: float = 0.6
                       ) -> np.ndarray:
    """MPII convention: headsize = SC_BIAS · ‖head bbox diagonal‖.

    head_bbox: (..., 4) as (x0, y0, x1, y1).
    """
    dx = head_bbox[..., 2] - head_bbox[..., 0]
    dy = head_bbox[..., 3] - head_bbox[..., 1]
    return sc_bias * np.hypot(dx, dy)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(min(ax1, bx1) - max(ax0, bx0), 0.0)
    ih = max(min(ay1, by1) - max(ay0, by0), 0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / max(union, 1e-9)


@dataclasses.dataclass
class PCKhEvaluator:
    """Streaming PCKh accumulator: add one image at a time, then summarize."""

    cfg: PPNConfig
    threshold: float = 0.5
    match_iou: float = 0.3

    def __post_init__(self):
        K = self.cfg.num_keypoints
        self.correct = np.zeros(K, np.int64)
        self.total = np.zeros(K, np.int64)

    def add_image(
        self,
        people: People,              # parsed predictions for ONE image
        gt_keypoints: np.ndarray,    # (Pg, K, 2) pixels
        gt_visible: np.ndarray,      # (Pg, K) bool
        gt_bboxes: np.ndarray,       # (Pg, 4) cxcywh pixels (instance boxes)
        gt_valid: np.ndarray,        # (Pg,) bool
        gt_headsizes: np.ndarray,    # (Pg,) pixels
    ) -> None:
        kp_box = np.asarray(people.kp_box)
        kp_valid = np.asarray(people.kp_valid)
        kp_score = np.asarray(people.kp_score)
        pvalid = np.asarray(people.valid)

        order = np.argsort(-kp_score[:, 0], kind="stable")
        gt_idx = [g for g in range(gt_valid.shape[0]) if gt_valid[g]]
        taken = set()
        matches = {}  # pred slot -> gt slot
        for p in order:
            if not pvalid[p]:
                continue
            best_g, best_iou = None, self.match_iou
            for g in gt_idx:
                if g in taken:
                    continue
                iou = _iou(kp_box[p, 0], gt_bboxes[g])
                if iou > best_iou:
                    best_g, best_iou = g, iou
            if best_g is not None:
                taken.add(best_g)
                matches[p] = best_g

        K = self.cfg.num_keypoints
        for g in gt_idx:
            vis = gt_visible[g]
            self.total += vis.astype(np.int64)
            pred = next((p for p, gg in matches.items() if gg == g), None)
            if pred is None:
                continue
            for k in range(K):
                if not vis[k]:
                    continue
                c = k + 1  # class index (0 = instance)
                if not kp_valid[pred, c]:
                    continue
                d = np.hypot(kp_box[pred, c, 0] - gt_keypoints[g, k, 0],
                             kp_box[pred, c, 1] - gt_keypoints[g, k, 1])
                if d < self.threshold * max(gt_headsizes[g], 1e-6):
                    self.correct[k] += 1

    def summarize(self) -> Dict[str, float]:
        names = self.cfg.keypoint_names[1:]
        per_joint = {
            f"pckh/{n}": (float(c) / t if t else 0.0)
            for n, c, t in zip(names, self.correct, self.total)}
        tot = int(self.total.sum())
        per_joint["pckh/mean"] = (
            float(self.correct.sum()) / tot if tot else 0.0)
        per_joint["pckh/num_joints"] = float(tot)
        return per_joint
