"""On-device training augmentation, batched (port of
``ppn_tpu/ops/augment.py``, its TPU batch path ``augment_batch`` lines
208-234, the path that runs the warp kernel).

Per image: random rotation, scale jitter, translation, horizontal flip with
the left/right keypoint-class swap, an optional person-centric crop/zoom,
and the PIL ImageEnhance color suite. The whole batch warps in ONE launch
of ``ppn_warp_kernel`` (``ops/cuda_warp.py``); keypoints and boxes move by
the matching forward matrices.

The draws come from a ``torch.Generator`` and cannot reproduce
``jax.random``'s stream, so the code splits in two: ``sample_params`` draws,
and ``apply_augment`` is deterministic given the draws — the part the tests
hold against the JAX package, fed the parameters JAX drew.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import DataConfig, PPNConfig
from ppn_tpu_torch.ops.cuda_warp import affine_warp_batch
from ppn_tpu_torch.ops.image import apply_affine_points, make_affine


class AugmentParams(NamedTuple):
    """One batch's draws."""

    bwd: torch.Tensor    # (B, 2, 3) OUTPUT→INPUT warp matrices
    fwd: torch.Tensor    # (B, 2, 3) INPUT→OUTPUT matrices for the GT
    scale: torch.Tensor  # (B,) output pixels per input pixel
    flip: torch.Tensor   # (B,) bool
    color: torch.Tensor  # (B, 4) brightness, contrast, saturation, sharpness


def flip_permutation(cfg: PPNConfig) -> list[int]:
    """Permutation over the K true keypoints (class index − 1) swapping
    left/right pairs."""
    perm = list(range(cfg.num_keypoints))
    for a, b in cfg.flip_pairs:
        perm[a - 1], perm[b - 1] = perm[b - 1], perm[a - 1]
    return perm


def smooth3x3(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageFilter.SMOOTH on (B, H, W, C): 3×3 kernel
    [[1,1,1],[1,5,1],[1,1,1]]/13, edge-replicated, as 9 shifted adds in the
    JAX function's order. The padded reads stay in the input dtype; the sum
    is f32."""
    H, W = img.shape[1:3]
    rows = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    p = img[:, rows][:, :, cols]
    acc = 4.0 * img.float()   # center weight 5 = 1 + 4 here
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + p[:, dy:dy + H, dx:dx + W].float()
    return acc / 13.0


def sample_params(cfg: PPNConfig, dcfg: DataConfig,
                  generator: torch.Generator, bboxes: torch.Tensor,
                  valid: torch.Tensor, shard: tuple[int, int] = (0, 1)
                  ) -> AugmentParams:
    """The draws of the JAX package's ``_sample_params`` for a whole batch,
    from ``generator`` on the batch's device: angle, scale, translation,
    flip, the categorical person pick and the crop gate, the crop fraction
    and the four color factors. bboxes (B, P, 4) cxcywh, valid (B, P).

    ``shard = (i, n)``: the batch is rows ``i·B … (i+1)·B`` of a global
    batch of ``n·B``. The draws are made for the global batch and this
    slice kept, so that ranks holding equal generators augment their
    slices as one process would augment the joined batch."""
    H, W = cfg.insize
    B = valid.shape[0]
    dev = bboxes.device
    i, n = shard
    rows = slice(i * B, (i + 1) * B)
    u = torch.rand((n * B, 11), generator=generator, device=dev)[rows]
    gum = torch.rand((n * B, *valid.shape[1:]), generator=generator,
                     device=dev)[rows]

    def uniform(col: int, lo: float, hi: float) -> torch.Tensor:
        return u[:, col] * (hi - lo) + lo

    angle = uniform(0, -dcfg.rotate_deg, dcfg.rotate_deg) * (math.pi / 180.0)
    scale = uniform(1, dcfg.scale_min, dcfg.scale_max)
    trans = torch.stack(
        [uniform(2, -dcfg.translate_frac, dcfg.translate_frac),
         uniform(3, -dcfg.translate_frac, dcfg.translate_frac)], -1
    ) * torch.tensor([W, H], dtype=torch.float32, device=dev)
    flip = u[:, 4] < dcfg.hflip_prob
    center = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32,
                          device=dev).expand(B, 2)

    # Person-centric crop/zoom: recenter the same affine on a random
    # annotated person (Gumbel-max categorical over the valid slots, as
    # jax.random.categorical draws) and zoom so its box max-dim covers a
    # sampled fraction of the output.
    valid_b = valid.bool()
    logits = torch.where(valid_b, 0.0, -1e9)
    tiny = torch.finfo(torch.float32).tiny
    pidx = torch.argmax(logits - torch.log(-torch.log(gum.clamp_min(tiny))),
                        dim=1)
    pbox = bboxes[torch.arange(B, device=dev), pidx].float()
    person_dim = torch.clamp_min(torch.maximum(pbox[:, 2], pbox[:, 3]), 1.0)
    frac = uniform(5, dcfg.crop_frac_min, dcfg.crop_frac_max)
    zoom = torch.clamp(frac * min(H, W) / person_dim, 0.25, 4.0)
    do_crop = (u[:, 6] < dcfg.crop_prob) & valid_b.any(dim=1)

    center_in = torch.where(do_crop[:, None], pbox[:, :2], center)
    scale = torch.where(do_crop, zoom * scale, scale)
    bwd, fwd = make_affine(center_in, center, angle, scale, trans, flip)

    one = torch.ones(B, device=dev)
    color = torch.stack([
        1.0 + uniform(7, -dcfg.color_jitter, dcfg.color_jitter),
        1.0 + uniform(8, -dcfg.color_jitter, dcfg.color_jitter),
        (1.0 + uniform(9, -dcfg.saturation_jitter, dcfg.saturation_jitter)
         if dcfg.saturation_jitter > 0 else one),
        (1.0 + uniform(10, -dcfg.sharpness_jitter, dcfg.sharpness_jitter)
         if dcfg.sharpness_jitter > 0 else one),
    ], dim=-1)
    return AugmentParams(bwd=bwd, fwd=fwd, scale=scale, flip=flip,
                         color=color)


def apply_color(dcfg: DataConfig, out: torch.Tensor,
                color: torch.Tensor) -> torch.Tensor:
    """Brightness/Contrast/Color(saturation)/Sharpness on (B, H, W, C), each
    a lerp between the image and a degenerate version, per image.

    Dtype-preserving as in the JAX package: a bf16 image rounds to bf16
    after each stage and is carried in f32 inside it; the means are f32."""
    dt = out.dtype
    b, c, s, sh = (color[:, i].float().view(-1, 1, 1, 1) for i in range(4))
    mean = out.float().mean(dim=(1, 2), keepdim=True)
    out = (((out.float() - mean) * c + mean) * b).to(dt)
    if dcfg.saturation_jitter > 0:
        o = out.float()
        gray = o[..., 0:1] * 0.299 + o[..., 1:2] * 0.587 + o[..., 2:3] * 0.114
        out = (gray + (o - gray) * s).to(dt)
    if dcfg.sharpness_jitter > 0:
        smooth = smooth3x3(out)
        out = (smooth + (out.float() - smooth) * sh).to(dt)
    return torch.clamp(out.float(), 0.0, 1.0).to(dt)


def transform_gt(cfg: PPNConfig, fwd: torch.Tensor, scale: torch.Tensor,
                 flip: torch.Tensor, keypoints: torch.Tensor,
                 visible: torch.Tensor, bboxes: torch.Tensor):
    """GT through the forward matrices: keypoints (B, P, K, 2), visible
    (B, P, K), bboxes (B, P, 4) → (keypoints, visible, bboxes)."""
    H, W = cfg.insize
    kp = apply_affine_points(fwd, keypoints)
    centers = apply_affine_points(fwd, bboxes[..., :2])
    wh = bboxes[..., 2:] * scale[:, None, None]  # axis-aligned under rotation
    new_boxes = torch.cat([centers, wh], dim=-1)

    # flip ⇒ swap left/right keypoint classes
    perm = flip_permutation(cfg)
    f = flip.view(-1, 1, 1)
    kp = torch.where(f[..., None], kp[:, :, perm], kp)
    vis = torch.where(f, visible[:, :, perm], visible)

    # joints pushed outside the frame become invisible
    inb = ((kp[..., 0] >= 0) & (kp[..., 0] < W)
           & (kp[..., 1] >= 0) & (kp[..., 1] < H))
    return kp, vis & inb, new_boxes


def apply_augment(cfg: PPNConfig, dcfg: DataConfig, params: AugmentParams,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Augment a batch with given draws: uint8 → f32/255, bf16 when
    ``augment_dtype == "bfloat16"``, one warp launch for the batch, the
    color suite, and the GT transform."""
    img = batch["image"]
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) / 255.0
    if dcfg.augment_dtype == "bfloat16":
        img = img.to(torch.bfloat16)
    out = affine_warp_batch(img, params.bwd)
    out = apply_color(dcfg, out, params.color)
    kp, vis, box = transform_gt(cfg, params.fwd, params.scale, params.flip,
                                batch["keypoints"], batch["visible"],
                                batch["bboxes"])
    return {"image": out, "keypoints": kp, "visible": vis, "bboxes": box,
            "valid": batch["valid"]}


def augment_batch(cfg: PPNConfig, dcfg: DataConfig,
                  generator: torch.Generator, batch,
                  device=None, shard: tuple[int, int] = (0, 1)
                  ) -> Dict[str, torch.Tensor]:
    """Draw and apply one batch's augmentation on ``device`` (``cuda``
    unless asked otherwise; ``generator`` must live there). ``batch`` holds
    image (B, H, W, 3) uint8 or float, keypoints, visible, bboxes, valid,
    as arrays or tensors; ``shard`` as ``sample_params`` takes it."""
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(batch[k]).to(dev)
             for k in ("image", "keypoints", "visible", "bboxes", "valid")}
    params = sample_params(cfg, dcfg, generator, batch["bboxes"],
                           batch["valid"], shard)
    return apply_augment(cfg, dcfg, params, batch)
