"""Per-class exact greedy IoU NMS on fixed-size tensors (port of
``ppn_tpu/ops/nms.py``).

Every grid cell is a proposal for every class. A proposal is kept iff it
clears ``detection_thresh`` and no higher-scored *kept* proposal of its class
overlaps it above ``nms_thresh`` — the sequential greedy rule, reached here
by the same parallel-wave fixpoint as the JAX package. The batch dimension
is written out instead of vmapped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops import boxes as boxops
from ppn_tpu_torch.ops.decode import Proposals


class NMSResult(NamedTuple):
    keep: torch.Tensor   # (B, H', W', K+1) bool — surviving proposals
    score: torch.Tensor  # (B, H', W', K+1) f32 — score where kept, else 0


def suppression_matrix(cfg: PPNConfig, props: Proposals):
    """(B, K1, N, N) M[b, c, i, j] = "j can suppress i": j earlier in greedy
    order (higher score, ties by lower index) and IoU(i, j) > nms_thresh and
    j above the detection threshold. Plus the (B, K1, N) above mask."""
    B = props.score.shape[0]
    K1 = cfg.num_classes
    N = cfg.outsize[0] * cfg.outsize[1]
    score = props.score.reshape(B, N, K1).transpose(1, 2)            # (B, K1, N)
    boxes = props.boxes.reshape(B, N, K1, 4).transpose(1, 2)         # (B, K1, N, 4)

    overlap = boxops.pairwise_overlap_above_cxcywh(boxes, boxes,
                                                   cfg.nms_thresh)
    idx = torch.arange(N, device=score.device)
    s_i, s_j = score[..., :, None], score[..., None, :]
    earlier = (s_j > s_i) | ((s_j == s_i) & (idx[None, :] < idx[:, None]))
    above = score > cfg.detection_thresh
    return overlap & earlier & above[..., None, :], above


def nms_batch(cfg: PPNConfig, props: Proposals) -> NMSResult:
    """Exact greedy NMS via parallel waves, all images and classes at once.

    Each wave drops every undecided proposal blocked by a kept one, then
    keeps every undecided proposal with no undecided earlier overlapping
    one — the JAX ``nms_single`` body. Finished images stay fixed, so one
    loop serves the batch."""
    M, above = suppression_matrix(cfg, props)
    kept = torch.zeros_like(above)
    undecided = above.clone()
    while bool(undecided.any()):
        blocked = (M & kept[..., None, :]).any(-1)
        undecided &= ~blocked
        higher_open = (M & undecided[..., None, :]).any(-1)
        newly_keep = undecided & ~higher_open
        kept |= newly_keep
        undecided &= ~newly_keep
    keep = kept.transpose(1, 2).reshape(props.score.shape)
    return NMSResult(keep=keep, score=torch.where(keep, props.score, 0.0))


def nms_single(cfg: PPNConfig, props: Proposals) -> NMSResult:
    """NMS for one image: props without the batch dimension."""
    one = nms_batch(cfg, Proposals(props.boxes[None], props.score[None]))
    return NMSResult(one.keep[0], one.score[0])
