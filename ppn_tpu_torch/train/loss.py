"""Multi-term PPN loss (port of ``ppn_tpu/train/loss.py``).

Five weighted masked-MSE terms:

    L =  λ_resp · Σ (δ − resp̂)²                      all cells/classes
       + λ_iou  · Σ δ · (IoU(box̂, gt) − conf̂)²       YOLOv1-style conf target
       + λ_coor · Σ δ · ((tx−x̂)² + (ty−ŷ)²)
       + λ_size · Σ δ · ((√tw−√ŵ)² + (√th−√ĥ)²)
       + λ_limb · Σ m · (te − ê)²                     m: limb mask or 1

The IoU target depends on the current predictions and acts as a label: it
is computed without gradient. Sizes are clamped to 1e-6 before the square
root. Terms are summed over cells and classes and averaged over the batch,
and returned under the JAX package's names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops import boxes as boxops
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops.encode import TargetGrids


def limb_mask(cfg: PPNConfig, delta: torch.Tensor) -> torch.Tensor:
    """(B, H', W', K+1) responsibility → (B, H', W', L, H_l, W_l) limb-loss
    weights: max(δ_src at the cell, δ_dst at the window-offset cell)."""
    H, W = cfg.outsize
    Hl, Wl = cfg.local_grid_size
    ch, cw = Hl // 2, Wl // 2
    src = [s for s, _ in cfg.edges]
    dst = [d for _, d in cfg.edges]

    d_src = delta[..., src]                                  # (B, H, W, L)
    padded = F.pad(delta[..., dst], (0, 0, cw, cw, ch, ch))
    windows = torch.stack(
        [padded[:, dy:dy + H, dx:dx + W, :] for dy in range(Hl)
         for dx in range(Wl)], dim=-1)                 # (B, H, W, L, Hl·Wl)
    windows = windows.reshape(*windows.shape[:-1], Hl, Wl)
    return torch.maximum(d_src[..., None, None], windows)


def ppn_loss(cfg: PPNConfig, feature_map: torch.Tensor,
             targets: TargetGrids) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """Total weighted loss + per-term logs, all in float32. feature_map is
    the (B, H', W', C) pre-activation head output."""
    fm = feature_map.to(torch.float32)
    act, props = dec.decode(cfg, fm)
    B = fm.shape[0]
    sy, sx = cfg.stride
    img_h, img_w = cfg.insize
    delta = targets.delta.to(torch.float32)

    # --- responsibility ----------------------------------------------------
    loss_resp = torch.sum(torch.square(delta - act.resp))

    # --- IoU confidence target (a label: no gradient) ----------------------
    H, W = cfg.outsize
    iy = torch.arange(H, dtype=torch.float32, device=fm.device)[:, None, None]
    ix = torch.arange(W, dtype=torch.float32, device=fm.device)[None, :, None]
    with torch.no_grad():
        gt_boxes = torch.stack([
            (ix + targets.tx) * sx,
            (iy + targets.ty) * sy,
            targets.tw * img_w,
            targets.th * img_h,
        ], dim=-1)
        iou_t = boxops.iou_cxcywh(props.boxes.detach(), gt_boxes)
    loss_iou = torch.sum(delta * torch.square(iou_t - act.conf))

    # --- coordinate offsets ------------------------------------------------
    loss_coor = torch.sum(delta * (torch.square(targets.tx - act.x)
                                   + torch.square(targets.ty - act.y)))

    # --- box size in sqrt space --------------------------------------------
    eps = 1e-6
    loss_size = torch.sum(delta * (
        torch.square(torch.sqrt(torch.clamp_min(targets.tw, eps))
                     - torch.sqrt(torch.clamp_min(act.w, eps)))
        + torch.square(torch.sqrt(torch.clamp_min(targets.th, eps))
                       - torch.sqrt(torch.clamp_min(act.h, eps)))))

    # --- limbs -------------------------------------------------------------
    limb_sq = torch.square(targets.te.to(torch.float32) - act.e)
    if cfg.limb_loss_mode == "paired":
        # mask to entries where either endpoint part exists: without it the
        # dense zero targets crush the sparse positives
        loss_limb = torch.sum(limb_mask(cfg, delta) * limb_sq)
    elif cfg.limb_loss_mode == "all":
        loss_limb = torch.sum(limb_sq)
    else:
        raise ValueError(f"unknown limb_loss_mode {cfg.limb_loss_mode!r}")

    inv_b = 1.0 / B
    terms = {
        "loss_resp": loss_resp * inv_b,
        "loss_iou": loss_iou * inv_b,
        "loss_coor": loss_coor * inv_b,
        "loss_size": loss_size * inv_b,
        "loss_limb": loss_limb * inv_b,
    }
    total = (cfg.lambda_resp * terms["loss_resp"]
             + cfg.lambda_iou * terms["loss_iou"]
             + cfg.lambda_coor * terms["loss_coor"]
             + cfg.lambda_size * terms["loss_size"]
             + cfg.lambda_limb * terms["loss_limb"])
    terms["loss_total"] = total
    return total, terms
