"""COCO keypoints evaluation: OKS-based AP (a copy of
``ppn_tpu/eval/coco_eval.py``).

Host numpy in float64: per-image greedy matching of score-ranked
predictions to GT by Object Keypoint Similarity, then 101-point
interpolated AP averaged over OKS thresholds 0.50:0.05:0.95. Both sorts are
Python's stable ``sorted``, so tied scores keep index order, as in the
original; the tests hold the summaries equal with ``==``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.parse import People

# Standard per-keypoint OKS falloff constants (COCO order, 17 joints).
COCO_SIGMAS = np.asarray([
    .026, .025, .025, .035, .035, .079, .079, .072, .072,
    .062, .062, .107, .107, .087, .087, .089, .089], np.float64)

_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def oks(pred_xy: np.ndarray, gt_xy: np.ndarray, gt_vis: np.ndarray,
        area: float, sigmas: np.ndarray, pred_valid: np.ndarray
        ) -> float:
    """Object Keypoint Similarity between one prediction and one GT."""
    vis = gt_vis > 0
    if not vis.any():
        return 0.0
    d2 = np.sum((pred_xy - gt_xy) ** 2, axis=-1)
    var = (2 * sigmas) ** 2
    s2 = max(float(area), 1.0)
    e = d2 / (2.0 * s2 * var)
    # a keypoint the predictor did not localize contributes similarity 0
    sim = np.where(pred_valid, np.exp(-e), 0.0)
    return float(sim[vis].mean())


@dataclasses.dataclass
class OKSEvaluator:
    """Streaming COCO-style keypoint AP accumulator over one image's host
    ``People`` at a time."""

    cfg: PPNConfig
    sigmas: np.ndarray = dataclasses.field(
        default_factory=lambda: COCO_SIGMAS)

    def __post_init__(self):
        if len(self.sigmas) != self.cfg.num_keypoints:
            # non-COCO keypoint sets fall back to a uniform sigma
            self.sigmas = np.full(self.cfg.num_keypoints, 0.07)
        self._dets: List[tuple] = []   # (score, matched[T] bool array)
        self._num_gt = 0

    def add_image(self, people: People, gt_keypoints: np.ndarray,
                  gt_visible: np.ndarray, gt_valid: np.ndarray,
                  gt_areas: np.ndarray) -> None:
        kp_box = np.asarray(people.kp_box)
        kp_valid = np.asarray(people.kp_valid)
        score = np.asarray(people.kp_score)[:, 0]
        pvalid = np.asarray(people.valid)

        gts = [g for g in range(gt_valid.shape[0]) if gt_valid[g]]
        self._num_gt += len(gts)
        preds = sorted([p for p in range(pvalid.shape[0]) if pvalid[p]],
                       key=lambda p: -score[p])

        mat = np.zeros((len(preds), len(gts)))
        for pi, p in enumerate(preds):
            for gi, g in enumerate(gts):
                mat[pi, gi] = oks(kp_box[p, 1:, :2], gt_keypoints[g],
                                  gt_visible[g], gt_areas[g], self.sigmas,
                                  kp_valid[p, 1:])

        for p in preds:
            self._dets.append((float(score[p]),
                               np.zeros(len(_THRESHOLDS), bool)))

        # per-threshold greedy matching in score order
        det_base = len(self._dets) - len(preds)
        for ti, t in enumerate(_THRESHOLDS):
            taken = set()
            for pi in range(len(preds)):
                best_g, best_o = None, t
                for gi in range(len(gts)):
                    if gi in taken:
                        continue
                    if mat[pi, gi] >= best_o:
                        best_g, best_o = gi, mat[pi, gi]
                if best_g is not None:
                    taken.add(best_g)
                    self._dets[det_base + pi][1][ti] = True

    def summarize(self) -> Dict[str, float]:
        if not self._dets or self._num_gt == 0:
            return {"oks/AP": 0.0, "oks/AP50": 0.0, "oks/AP75": 0.0}
        dets = sorted(self._dets, key=lambda d: -d[0])
        matched = np.stack([d[1] for d in dets])     # (D, T)
        tp = np.cumsum(matched, axis=0)
        fp = np.cumsum(~matched, axis=0)
        recall = tp / self._num_gt
        precision = tp / np.maximum(tp + fp, 1)

        aps = []
        for ti in range(len(_THRESHOLDS)):
            p = precision[:, ti]
            r = recall[:, ti]
            # COCO 101-point interpolation
            p_interp = np.maximum.accumulate(p[::-1])[::-1]
            ap = 0.0
            for rt in np.linspace(0, 1, 101):
                idx = np.searchsorted(r, rt, side="left")
                ap += p_interp[idx] if idx < len(p_interp) else 0.0
            aps.append(ap / 101)
        aps = np.asarray(aps)
        return {
            "oks/AP": float(aps.mean()),
            "oks/AP50": float(aps[0]),
            "oks/AP75": float(aps[5]),
            "oks/num_gt": float(self._num_gt),
        }
