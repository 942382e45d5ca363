"""GT → target-grid encoding (port of ``ppn_tpu/ops/encode.py``), with the
batch written out.

Conventions (per image of the batch):
* ``keypoints``: (B, P, K, 2) float — (x, y) pixels in the network input
  frame; K excludes the instance class.
* ``visible``:  (B, P, K) bool.
* ``bboxes``:   (B, P, 4) float — person boxes (cx, cy, w, h) in pixels.
* ``valid``:    (B, P) bool — the person slot holds an annotation.

Output grids:
* delta (B, H', W', K+1)   1 at the cell holding each GT center.
* tx, ty (B, H', W', K+1)  center offset within the cell, in [0, 1).
* tw, th (B, H', W', K+1)  box size over the input image size.
* te (B, H', W', L, H_l, W_l)  limb indicator: 1 iff some person has limb
  l's source part in cell (y, x) and its destination part in cell
  (y + dy − ⌊H_l/2⌋, x + dx − ⌊W_l/2⌋).

Hazard — two persons' parts in one (cell, class). The JAX package writes
the four box fields in one ``.set`` scatter, whose winner on duplicates is
the last writer, the highest person index. On CUDA ``index_put_`` with
duplicate indices has no defined winner and may even mix two persons'
fields. Here the winner is picked first, deterministically: the highest
person index among the valid writers (``scatter_reduce`` amax), then its
four fields are gathered. ``delta`` and ``te`` are maxima, order-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ppn_tpu_torch import constant
from ppn_tpu_torch.configs import PPNConfig


class TargetGrids(NamedTuple):
    """Encoded training targets, batched."""

    delta: torch.Tensor  # (B, H', W', K+1)
    tx: torch.Tensor     # (B, H', W', K+1)
    ty: torch.Tensor     # (B, H', W', K+1)
    tw: torch.Tensor     # (B, H', W', K+1)
    th: torch.Tensor     # (B, H', W', K+1)
    te: torch.Tensor     # (B, H', W', L, H_l, W_l)


def encode_batch(cfg: PPNConfig, keypoints: torch.Tensor,
                 visible: torch.Tensor, bboxes: torch.Tensor,
                 valid: torch.Tensor) -> TargetGrids:
    """Encode a batch's GT into target grids. See the module docstring."""
    B, P, K = visible.shape
    K1 = cfg.num_classes
    H, W = cfg.outsize
    Hl, Wl = cfg.local_grid_size
    L = cfg.num_limbs
    sy, sx = cfg.stride
    img_h, img_w = cfg.insize
    dev = keypoints.device
    f32 = torch.float32

    keypoints = keypoints.to(f32)
    bboxes = bboxes.to(f32)
    valid = valid.bool()
    visible = visible.bool()

    # ---- per-(person, class) centers and box sizes ------------------------
    # class 0 = instance (person box center), classes 1..K = joints.
    centers = torch.cat([bboxes[:, :, None, :2], keypoints], dim=2)
    inst_wh = bboxes[..., 2:4] * cfg.instance_scale                # (B,P,2)
    # keypoint boxes: squares of side parts_scale·√(w_inst² + h_inst²); the
    # f32 root is taken through f64, which rounds it correctly (PyTorch's
    # CPU sqrt can be an ulp off, and the JAX package's is exact)
    part_side = cfg.parts_scale * torch.sqrt(
        (torch.square(inst_wh[..., 0]) + torch.square(inst_wh[..., 1]))
        .double()).float()
    part_wh = part_side[:, :, None, None].expand(B, P, K, 2)
    sizes = torch.cat([inst_wh[:, :, None, :], part_wh], dim=2)    # (B,P,K1,2)

    ok = torch.cat([valid[:, :, None], visible & valid[:, :, None]], dim=2)

    # ---- grid cell + in-cell offset ---------------------------------------
    gx = centers[..., 0] / sx
    gy = centers[..., 1] / sy
    ix = torch.floor(gx).long()
    iy = torch.floor(gy).long()
    ok = ok & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)

    # invalid writes go to a trash row/col (grids padded by one)
    iy_s = torch.where(ok, iy, H)
    ix_s = torch.where(ok, ix, W)
    bi = torch.arange(B, device=dev)[:, None, None]
    cls = torch.arange(K1, device=dev)[None, None, :]
    cell = ((bi * (H + 1) + iy_s) * (W + 1) + ix_s) * K1 + cls    # (B,P,K1)
    n_cells = B * (H + 1) * (W + 1) * K1

    delta = torch.zeros(n_cells, dtype=f32, device=dev).scatter_reduce(
        0, cell.reshape(-1), ok.to(f32).reshape(-1), "amax")
    delta = delta.view(B, H + 1, W + 1, K1)[:, :H, :W]

    # the box fields of the highest valid person index per (cell, class)
    person = torch.arange(P, device=dev)[None, :, None].expand(B, P, K1)
    winner = torch.full((n_cells,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(
        0, cell.reshape(-1), torch.where(ok, person, -1).reshape(-1), "amax")
    winner = winner.view(B, H + 1, W + 1, K1)[:, :H, :W]
    box_vals = torch.stack(
        [gx - ix.to(f32), gy - iy.to(f32), sizes[..., 0] / img_w,
         sizes[..., 1] / img_h], dim=-1)                           # (B,P,K1,4)
    picked = box_vals[bi[..., None], winner.clamp_min(0),
                      cls[:, None]]                                # (B,H,W,K1,4)
    picked = torch.where((winner >= 0)[..., None], picked, 0.0)
    tx, ty, tw, th = picked.unbind(-1)

    # ---- limb connectivity te ---------------------------------------------
    src = constant([e[0] for e in cfg.edges], torch.long, dev)
    dst = constant([e[1] for e in cfg.edges], torch.long, dev)
    iy_src = iy[:, :, src]                                         # (B,P,L)
    ix_src = ix[:, :, src]
    dy = iy[:, :, dst] - iy_src + Hl // 2
    dx = ix[:, :, dst] - ix_src + Wl // 2
    pair_ok = (ok[:, :, src] & ok[:, :, dst]
               & (dy >= 0) & (dy < Hl) & (dx >= 0) & (dx < Wl))
    iy_e = torch.where(pair_ok, iy_src, H)
    ix_e = torch.where(pair_ok, ix_src, W)
    lidx = torch.arange(L, device=dev)[None, None, :]
    flat = ((((bi * (H + 1) + iy_e) * (W + 1) + ix_e) * L + lidx) * Hl
            + dy.clamp(0, Hl - 1)) * Wl + dx.clamp(0, Wl - 1)
    te = torch.zeros(B * (H + 1) * (W + 1) * L * Hl * Wl, dtype=f32,
                     device=dev).scatter_reduce(
        0, flat.reshape(-1), pair_ok.to(f32).reshape(-1), "amax")
    te = te.view(B, H + 1, W + 1, L, Hl, Wl)[:, :H, :W]

    return TargetGrids(delta=delta, tx=tx, ty=ty, tw=tw, th=th, te=te)


def encode_single(cfg: PPNConfig, keypoints, visible, bboxes,
                  valid) -> TargetGrids:
    """One image's GT (arrays or tensors without the batch dimension) as
    target grids without it: ``encode_batch`` on a batch of one."""
    one = encode_batch(cfg, *(torch.as_tensor(x)[None] for x in (
        keypoints, visible, bboxes, valid)))
    return TargetGrids(*(t[0] for t in one))


def targets_to_feature_map(cfg: PPNConfig, t: TargetGrids) -> torch.Tensor:
    """A pre-activation feature map that decodes back to the targets: every
    GT box at its responsible cell with score ≈ 1 (the round-trip oracle of
    the encode/decode contract)."""
    BIG = 12.0  # σ(±12) ≈ 1/0 to ~6e-6

    def logit(p):
        p = torch.clamp(p, 1e-5, 1.0 - 1e-5)
        return torch.log(p) - torch.log1p(-p)

    resp = torch.where(t.delta > 0.5, BIG, -BIG)
    conf = resp  # perfect boxes ⇒ IoU target 1 at responsible cells
    x = logit(t.tx)
    y = logit(t.ty)
    if cfg.size_activation == "sigmoid":
        w = logit(t.tw)
        h = logit(t.th)
    else:
        w = torch.log(torch.clamp_min(t.tw, 1e-5))
        h = torch.log(torch.clamp_min(t.th, 1e-5))
    e = torch.where(t.te > 0.5, BIG, -BIG)
    e_flat = e.reshape(*e.shape[:-3], cfg.num_limb_channels)
    return torch.cat([resp, conf, x, y, w, h, e_flat], dim=-1)
