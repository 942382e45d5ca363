"""Greedy limb parsing (person assembly) on fixed-size tensors (port of
``ppn_tpu/ops/parse.py``).

Seed one person per surviving `instance` proposal (top-P), walk the directed
limb tree, and for each edge (s→t) pick the t-candidate inside the local
window around s's cell maximizing limb-probability × t-score; finally drop
persons with too few keypoints.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.decode import Activations, Proposals
from ppn_tpu_torch.ops.nms import NMSResult


class People(NamedTuple):
    """Fixed-shape parsed output, one row per person slot (batched: a
    leading B dimension).

    kp_cell:  (P, K+1, 2) int32 — (iy, ix) grid cell per class (0 = instance)
    kp_box:   (P, K+1, 4) f32   — decoded box at that cell (cx, cy, w, h) px
    kp_score: (P, K+1) f32      — proposal score at that cell
    kp_valid: (P, K+1) bool     — keypoint found for this person
    valid:    (P,) bool         — person survives min_num_keypoints filter
    num_kp:   (P,) int32        — number of valid true keypoints (excl. inst.)
    """

    kp_cell: torch.Tensor
    kp_box: torch.Tensor
    kp_score: torch.Tensor
    kp_valid: torch.Tensor
    valid: torch.Tensor
    num_kp: torch.Tensor


def window_tables(cfg: PPNConfig):
    """Static (NW, N) tables: flat-index shift per window offset j, whether
    offset j stays in bounds from cell n, and the neighbor's flat index
    (0 where out of bounds)."""
    H, W = cfg.outsize
    Hl, Wl = cfg.local_grid_size
    N, NW = H * W, Hl * Wl
    ch, cw = Hl // 2, Wl // 2
    shifts = [(j // Wl - ch) * W + (j % Wl - cw) for j in range(NW)]
    n_idx = np.arange(N)
    yy, xx = n_idx // W, n_idx % W
    nbrv = np.zeros((NW, N), bool)
    nbrc = np.zeros((NW, N), np.int64)
    for j, s in enumerate(shifts):
        dy, dx = j // Wl - ch, j % Wl - cw
        ok = (yy + dy >= 0) & (yy + dy < H) & (xx + dx >= 0) & (xx + dx < W)
        nbrv[j] = ok
        nbrc[j] = np.where(ok, n_idx + s, 0)
    return shifts, nbrv, nbrc


def _edge_best_maps_flat(cfg: PPNConfig, e: torch.Tensor,
                         score: torch.Tensor):
    """Per-edge best-destination maps for every source cell, batched.

    For image b, source cell n and limb l: the best over the window of
    ``e[b, n, l, j] · score_dst(nbr(j, n))``. Returns (best_val, dst_cell,
    dst_score), each (B, N, L). The winner is the first j reaching the
    maximum (row-major window order), and only a maximum > 0 wins.
    """
    B = score.shape[0]
    H, W = cfg.outsize
    K1 = cfg.num_classes
    L = cfg.num_limbs
    N = H * W
    dev = score.device
    shifts, nbrv, nbrc = window_tables(cfg)
    NW = len(shifts)

    dst = torch.tensor([d for _, d in cfg.edges], device=dev)
    D = score.reshape(B, N, K1)[:, :, dst]                        # (B, N, L)
    rolls = torch.stack([torch.roll(D, -s, dims=1) for s in shifts],
                        dim=1)                                     # (B, NW, N, L)
    nbrv_t = torch.from_numpy(nbrv).to(dev)[None, :, :, None]
    e_t = e.reshape(B, N, L, NW).permute(0, 3, 1, 2)              # (B, NW, N, L)
    esc = torch.where(nbrv_t, e_t * rolls, 0.0)

    bv = esc.amax(dim=1)                                           # (B, N, L)
    jrow = torch.arange(NW, device=dev)[None, :, None, None]
    is_best = (esc == bv[:, None]) & (bv[:, None] > 0.0)
    firstj = torch.where(is_best, jrow, NW).amin(dim=1)           # (B, N, L)
    found = firstj < NW
    jsel = torch.where(found, firstj, 0)
    nbrc_t = torch.from_numpy(nbrc).to(dev)                        # (NW, N)
    n_idx = torch.arange(N, device=dev)[None, :, None]
    dst_cell = torch.where(found, nbrc_t[jsel, n_idx], 0)
    dst_score = torch.gather(rolls, 1, jsel[:, None]).squeeze(1)
    return bv, dst_cell, torch.where(found, dst_score, 0.0)


def parse_batch(cfg: PPNConfig, act: Activations, props: Proposals,
                nms: NMSResult) -> People:
    """Assemble persons for a batch of images from post-NMS proposals."""
    B = nms.score.shape[0]
    H, W = cfg.outsize
    K1 = cfg.num_classes
    P = cfg.max_instances
    N = H * W
    dev = nms.score.device

    score = nms.score                      # (B, H, W, K1), zero where dropped
    bv, dcell, dscore = _edge_best_maps_flat(cfg, act.e, score)

    # ---- seed: top-P surviving instance proposals --------------------------
    # Hazard: jax.lax.top_k returns ties in ascending index, the all-zero
    # (no seed) case included, and torch.topk does not promise that order;
    # a stable descending sort does.
    inst = score[..., 0].reshape(B, N)
    top_v, top_i = torch.sort(inst, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :P], top_i[:, :P]

    zeros_i = torch.zeros((B, P), dtype=torch.int64, device=dev)
    cell_f = [top_i] + [zeros_i] * (K1 - 1)                 # flat cells
    score_c = [top_v] + [torch.zeros((B, P), device=dev)] * (K1 - 1)
    valid_c = [top_v > 0.0] + [torch.zeros((B, P), dtype=torch.bool,
                                           device=dev)] * (K1 - 1)

    for l, (s_cls, d_cls) in enumerate(cfg.edges):
        src = cell_f[s_cls]
        ev = torch.gather(bv[:, :, l], 1, src)
        ok = valid_c[s_cls] & (ev > 0.0)
        cell_f[d_cls] = torch.where(
            ok, torch.gather(dcell[:, :, l], 1, src), 0)
        score_c[d_cls] = torch.where(
            ok, torch.gather(dscore[:, :, l], 1, src), 0.0)
        valid_c[d_cls] = ok

    kp_flat = torch.stack(cell_f, dim=2)                    # (B, P, K1)
    kp_score = torch.stack(score_c, dim=2)
    kp_valid = torch.stack(valid_c, dim=2)
    kp_cell = torch.stack([kp_flat // W, kp_flat % W], dim=-1).to(torch.int32)

    # ---- gather boxes at assigned cells ------------------------------------
    boxes = props.boxes.reshape(B, N, K1, 4)
    b_idx = torch.arange(B, device=dev)[:, None, None]
    cls_idx = torch.arange(K1, device=dev)[None, None, :]
    kp_box = boxes[b_idx, kp_flat, cls_idx]                 # (B, P, K1, 4)
    kp_box = torch.where(kp_valid[..., None], kp_box, 0.0)

    # Hazard: kp_box and kp_score are masked by per-keypoint validity only;
    # kp_valid also by the person filter.
    num_kp = kp_valid[..., 1:].sum(-1).to(torch.int32)
    valid = kp_valid[..., 0] & (num_kp >= cfg.min_num_keypoints)
    return People(kp_cell=kp_cell, kp_box=kp_box, kp_score=kp_score,
                  kp_valid=kp_valid & valid[..., None], valid=valid,
                  num_kp=num_kp)


def parse_single(cfg: PPNConfig, act: Activations, props: Proposals,
                 nms: NMSResult) -> People:
    """Assemble persons for one image (inputs without the batch dim)."""
    one = parse_batch(cfg, Activations(*(t[None] for t in act)),
                      Proposals(*(t[None] for t in props)),
                      NMSResult(*(t[None] for t in nms)))
    return People(*(t[0] for t in one))
