"""Head decode: feature map → activations → boxes + scores (port of
``ppn_tpu/ops/decode.py``).

Feature-map layout (NHWC, grouped by quantity then class):

    channels = [resp(K+1) | conf(K+1) | x(K+1) | y(K+1) | w(K+1) | h(K+1)
                | limbs(L·H_l·W_l)]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ppn_tpu_torch.configs import PPNConfig


class RawHead(NamedTuple):
    """Pre-activation channel groups, each (..., H', W', K+1) except e."""

    resp: torch.Tensor
    conf: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    e: torch.Tensor  # (..., H', W', L, H_l, W_l)


class Activations(NamedTuple):
    """Post-activation head quantities (same shapes as RawHead)."""

    resp: torch.Tensor
    conf: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    e: torch.Tensor


class Proposals(NamedTuple):
    """Decoded per-cell proposals.

    boxes: (..., H', W', K+1, 4) center-format pixels in the input frame.
    score: (..., H', W', K+1)    = resp·conf.
    """

    boxes: torch.Tensor
    score: torch.Tensor


def split_feature_map(cfg: PPNConfig, fm: torch.Tensor) -> RawHead:
    """Split a (..., H', W', C) head output into its channel groups."""
    K1 = cfg.num_classes
    Hl, Wl = cfg.local_grid_size
    L = cfg.num_limbs
    if fm.shape[-1] != cfg.num_channels:
        raise ValueError(
            f"feature map has {fm.shape[-1]} channels, config expects "
            f"{cfg.num_channels}")
    groups = [fm[..., i * K1:(i + 1) * K1] for i in range(6)]
    e = fm[..., 6 * K1:].reshape(*fm.shape[:-1], L, Hl, Wl)
    return RawHead(*groups, e)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """σ on the f32 upcast, as ``1 / (1 + exp(-x))`` — the formula of
    ``jax.nn.sigmoid`` and of the CUDA kernel, so the kernel and this
    version round alike on the card."""
    return 1.0 / (1.0 + torch.exp(-x.to(torch.float32)))


def activate(cfg: PPNConfig, raw: RawHead) -> Activations:
    """σ on resp/conf/offsets/limbs; sizes via σ or exp (clipped to
    [−10, 4]), per config."""
    if cfg.size_activation == "sigmoid":
        w, h = sigmoid(raw.w), sigmoid(raw.h)
    elif cfg.size_activation == "exp":
        w = torch.exp(torch.clamp(raw.w.to(torch.float32), -10.0, 4.0))
        h = torch.exp(torch.clamp(raw.h.to(torch.float32), -10.0, 4.0))
    else:
        raise ValueError(f"unknown size_activation {cfg.size_activation!r}")
    return Activations(resp=sigmoid(raw.resp), conf=sigmoid(raw.conf),
                       x=sigmoid(raw.x), y=sigmoid(raw.y), w=w, h=h,
                       e=sigmoid(raw.e))


def decode_boxes(cfg: PPNConfig, act: Activations) -> Proposals:
    """Centers = (cell + σ(offset))·stride; sizes scaled by the input size."""
    H, W = cfg.outsize
    sy, sx = cfg.stride
    img_h, img_w = cfg.insize
    dev = act.x.device
    iy = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    ix = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]

    cx = (ix + act.x) * sx
    cy = (iy + act.y) * sy
    bw = act.w * img_w
    bh = act.h * img_h
    boxes = torch.stack([cx, cy, bw, bh], dim=-1)
    score = act.resp * act.conf
    return Proposals(boxes=boxes, score=score)


def decode(cfg: PPNConfig, fm: torch.Tensor) -> tuple[Activations, Proposals]:
    """Full decode pipeline: raw head → activations → proposals."""
    act = activate(cfg, split_feature_map(cfg, fm))
    return act, decode_boxes(cfg, act)
