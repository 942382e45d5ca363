"""Box utilities, center format ``(cx, cy, w, h)`` in pixels (port of
``ppn_tpu/ops/boxes.py``)."""

from __future__ import annotations

import torch


def box_area(wh: torch.Tensor) -> torch.Tensor:
    """Area from a trailing-dim-2 (w, h) tensor."""
    return wh[..., 0] * wh[..., 1]


def cxcywh_to_tlbr(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (x0, y0, x1, y1)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def iou_cxcywh(a: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """Elementwise IoU of broadcast-compatible center-format boxes, in the
    JAX function's operation order (the loss's confidence target)."""
    ax0 = a[..., 0] - a[..., 2] / 2
    ay0 = a[..., 1] - a[..., 3] / 2
    ax1 = a[..., 0] + a[..., 2] / 2
    ay1 = a[..., 1] + a[..., 3] / 2
    bx0 = b[..., 0] - b[..., 2] / 2
    by0 = b[..., 1] - b[..., 3] / 2
    bx1 = b[..., 0] + b[..., 2] / 2
    by1 = b[..., 1] + b[..., 3] / 2

    iw = torch.clamp_min(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    ih = torch.clamp_min(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / torch.clamp_min(union, eps)


def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: a (..., N, 4) × b (..., M, 4) → (..., N, M)."""
    return iou_cxcywh(a[..., :, None, :], b[..., None, :, :])


def pairwise_overlap_above_cxcywh(a: torch.Tensor, b: torch.Tensor,
                                  thresh: float,
                                  eps: float = 1e-9) -> torch.Tensor:
    """All-pairs "IoU > thresh" decision, divide-free: a (..., N, 4) ×
    b (..., M, 4) → (..., N, M) bool.

    ``inter > thresh·max(union, eps)`` with the JAX function's operation
    order, so that every decision is the same float computation.

    Hazard — the area term: here, as in the XLA reference, it comes from
    the corners, ``(x1−x0)·(y1−y0)``; the TPU Pallas kernel used ``w·h``,
    which rounds differently. The CUDA post-process kernel follows this
    function."""
    ax0 = a[..., :, None, 0] - a[..., :, None, 2] / 2
    ay0 = a[..., :, None, 1] - a[..., :, None, 3] / 2
    ax1 = a[..., :, None, 0] + a[..., :, None, 2] / 2
    ay1 = a[..., :, None, 1] + a[..., :, None, 3] / 2
    bx0 = b[..., None, :, 0] - b[..., None, :, 2] / 2
    by0 = b[..., None, :, 1] - b[..., None, :, 3] / 2
    bx1 = b[..., None, :, 0] + b[..., None, :, 2] / 2
    by1 = b[..., None, :, 1] + b[..., None, :, 3] / 2

    iw = torch.clamp_min(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    ih = torch.clamp_min(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter > thresh * torch.clamp_min(union, eps)
