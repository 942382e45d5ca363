"""The plain reference of the post-process: decode → per-class exact greedy
NMS → greedy limb-tree parse, on fixed-size tensors. A frozen copy of the
program's plain versions (``ppn_tpu_torch/ops/{decode,nms,parse,boxes}.py``
at commit 6c798b19f2f81ac884339f9f662eb9e6d03a12e7) over a ``Geometry``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Activations(NamedTuple):
    resp: torch.Tensor
    conf: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    e: torch.Tensor     # (..., H', W', L, H_l, W_l)


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (..., H', W', K+1, 4) cx, cy, w, h in pixels
    score: torch.Tensor  # (..., H', W', K+1) resp · conf


class People(NamedTuple):
    kp_cell: torch.Tensor   # (B, P, K+1, 2) int32 (iy, ix)
    kp_box: torch.Tensor    # (B, P, K+1, 4)
    kp_score: torch.Tensor  # (B, P, K+1)
    kp_valid: torch.Tensor  # (B, P, K+1) bool
    valid: torch.Tensor     # (B, P) bool
    num_kp: torch.Tensor    # (B, P) int32


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x.to(torch.float32)))


def decode(g, fm: torch.Tensor):
    """(B, H', W', C) map → (Activations, Proposals)."""
    K1 = g.num_classes
    Hl, Wl = g.local_grid_size
    grp = [fm[..., i * K1:(i + 1) * K1] for i in range(6)]
    e = fm[..., 6 * K1:].reshape(*fm.shape[:-1], g.num_limbs, Hl, Wl)
    if g.size_activation == "sigmoid":
        w, h = sigmoid(grp[4]), sigmoid(grp[5])
    else:
        w = torch.exp(torch.clamp(grp[4].float(), -10.0, 4.0))
        h = torch.exp(torch.clamp(grp[5].float(), -10.0, 4.0))
    act = Activations(sigmoid(grp[0]), sigmoid(grp[1]), sigmoid(grp[2]),
                      sigmoid(grp[3]), w, h, sigmoid(e))
    H, W = g.outsize
    sy, sx = g.stride
    img_h, img_w = g.insize
    iy = torch.arange(H, dtype=torch.float32, device=fm.device)[:, None, None]
    ix = torch.arange(W, dtype=torch.float32, device=fm.device)[None, :, None]
    boxes = torch.stack([(ix + act.x) * sx, (iy + act.y) * sy,
                         act.w * img_w, act.h * img_h], dim=-1)
    return act, Proposals(boxes, act.resp * act.conf)


def iou_cxcywh(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9):
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp_min(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    ih = torch.clamp_min(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / torch.clamp_min(union, eps)


def _overlap_above(a: torch.Tensor, b: torch.Tensor, thresh: float,
                   eps: float = 1e-9) -> torch.Tensor:
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


def nms(g, props: Proposals) -> torch.Tensor:
    """Post-NMS scores (B, H', W', K+1): the score where kept, else 0. The
    sequential greedy rule per class, reached by parallel waves."""
    B = props.score.shape[0]
    K1 = g.num_classes
    N = g.outsize[0] * g.outsize[1]
    score = props.score.reshape(B, N, K1).transpose(1, 2)
    boxes = props.boxes.reshape(B, N, K1, 4).transpose(1, 2)
    overlap = _overlap_above(boxes, boxes, g.nms_thresh)
    idx = torch.arange(N, device=score.device)
    s_i, s_j = score[..., :, None], score[..., None, :]
    earlier = (s_j > s_i) | ((s_j == s_i) & (idx[None, :] < idx[:, None]))
    above = score > g.detection_thresh
    M = overlap & earlier & above[..., None, :]
    kept = torch.zeros_like(above)
    undecided = above.clone()
    while bool(undecided.any()):
        undecided = undecided & ~(M & kept[..., None, :]).any(-1)
        newly = undecided & ~(M & undecided[..., None, :]).any(-1)
        kept, undecided = kept | newly, undecided & ~newly
    keep = kept.transpose(1, 2).reshape(props.score.shape)
    return torch.where(keep, props.score, 0.0)


def window_tables(g):
    """Per window offset j: the flat shift, whether the neighbour of cell n
    is in frame, and its flat index (0 outside)."""
    H, W = g.outsize
    Hl, Wl = g.local_grid_size
    N, NW = H * W, Hl * Wl
    ch, cw = Hl // 2, Wl // 2
    shifts = [(j // Wl - ch) * W + (j % Wl - cw) for j in range(NW)]
    n = np.arange(N)
    yy, xx = n // W, n % W
    nbrv = np.zeros((NW, N), bool)
    nbrc = np.zeros((NW, N), np.int64)
    for j, s in enumerate(shifts):
        dy, dx = j // Wl - ch, j % Wl - cw
        ok = (yy + dy >= 0) & (yy + dy < H) & (xx + dx >= 0) & (xx + dx < W)
        nbrv[j] = ok
        nbrc[j] = np.where(ok, n + s, 0)
    return shifts, nbrv, nbrc


def _edge_best(g, e: torch.Tensor, score: torch.Tensor):
    B = score.shape[0]
    H, W = g.outsize
    K1, L, N = g.num_classes, g.num_limbs, H * W
    dev = score.device
    shifts, nbrv, nbrc = window_tables(g)
    NW = len(shifts)
    dst = torch.tensor([d for _, d in g.edges], device=dev)
    D = score.reshape(B, N, K1)[:, :, dst]
    rolls = torch.stack([torch.roll(D, -s, dims=1) for s in shifts], dim=1)
    nbrv_t = torch.from_numpy(nbrv).to(dev)[None, :, :, None]
    e_t = e.reshape(B, N, L, NW).permute(0, 3, 1, 2)
    esc = torch.where(nbrv_t, e_t * rolls, 0.0)
    bv = esc.amax(dim=1)
    jrow = torch.arange(NW, device=dev)[None, :, None, None]
    is_best = (esc == bv[:, None]) & (bv[:, None] > 0.0)
    firstj = torch.where(is_best, jrow, NW).amin(dim=1)
    found = firstj < NW
    jsel = torch.where(found, firstj, 0)
    nbrc_t = torch.from_numpy(nbrc).to(dev)
    n_idx = torch.arange(N, device=dev)[None, :, None]
    dst_cell = torch.where(found, nbrc_t[jsel, n_idx], 0)
    dst_score = torch.gather(rolls, 1, jsel[:, None]).squeeze(1)
    return bv, dst_cell, torch.where(found, dst_score, 0.0)


def parse(g, act: Activations, props: Proposals,
          score: torch.Tensor) -> People:
    """Persons from the post-NMS ``score``: one seed per surviving instance
    proposal (top-P, ties by lower cell), the limb tree walked greedily."""
    B = score.shape[0]
    H, W = g.outsize
    K1, P, N = g.num_classes, g.max_instances, H * W
    dev = score.device
    bv, dcell, dscore = _edge_best(g, act.e, score)
    inst = score[..., 0].reshape(B, N)
    top_v, top_i = torch.sort(inst, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :P], top_i[:, :P]
    zeros_i = torch.zeros((B, P), dtype=torch.int64, device=dev)
    cell_f = [top_i] + [zeros_i] * (K1 - 1)
    score_c = [top_v] + [torch.zeros((B, P), device=dev)] * (K1 - 1)
    valid_c = [top_v > 0.0] + [torch.zeros((B, P), dtype=torch.bool,
                                           device=dev)] * (K1 - 1)
    for l, (s_cls, d_cls) in enumerate(g.edges):
        src = cell_f[s_cls]
        ev = torch.gather(bv[:, :, l], 1, src)
        ok = valid_c[s_cls] & (ev > 0.0)
        cell_f[d_cls] = torch.where(ok, torch.gather(dcell[:, :, l], 1, src), 0)
        score_c[d_cls] = torch.where(
            ok, torch.gather(dscore[:, :, l], 1, src), 0.0)
        valid_c[d_cls] = ok
    kp_flat = torch.stack(cell_f, dim=2)
    kp_score = torch.stack(score_c, dim=2)
    kp_valid = torch.stack(valid_c, dim=2)
    kp_cell = torch.stack([kp_flat // W, kp_flat % W], dim=-1).to(torch.int32)
    boxes = props.boxes.reshape(B, N, K1, 4)
    b_idx = torch.arange(B, device=dev)[:, None, None]
    cls_idx = torch.arange(K1, device=dev)[None, None, :]
    kp_box = torch.where(kp_valid[..., None], boxes[b_idx, kp_flat, cls_idx],
                         0.0)
    num_kp = kp_valid[..., 1:].sum(-1).to(torch.int32)
    valid = kp_valid[..., 0] & (num_kp >= g.min_num_keypoints)
    return People(kp_cell, kp_box, kp_score, kp_valid & valid[..., None],
                  valid, num_kp)


def postprocess(g, fm: torch.Tensor) -> People:
    act, props = decode(g, fm)
    return parse(g, act, props, nms(g, props))
