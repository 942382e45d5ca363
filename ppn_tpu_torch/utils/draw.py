"""Skeleton visualization (port of ``ppn_tpu/utils/draw.py``): per-keypoint
boxes, limb segments and the instance box of each person, one color per
person, drawn with PIL. PIL is imported when a picture is drawn, so the
module imports where PIL is missing."""

from __future__ import annotations

import colorsys

import numpy as np

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.parse import People


def _person_color(i: int) -> tuple:
    r, g, b = colorsys.hsv_to_rgb((i * 0.37) % 1.0, 0.9, 1.0)
    return (int(r * 255), int(g * 255), int(b * 255))


def draw_people(cfg: PPNConfig, image: np.ndarray, people: People,
                line_width: int = 2):
    """image: (H, W, 3) float [0,1] or uint8, in the network input frame;
    ``people``: one image's People as host arrays. Returns a PIL image with
    the skeletons overlaid."""
    from PIL import Image, ImageDraw

    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    img = Image.fromarray(image).convert("RGB")
    d = ImageDraw.Draw(img)

    kp_box = np.asarray(people.kp_box)
    kp_valid = np.asarray(people.kp_valid)
    valid = np.asarray(people.valid)

    for p in range(valid.shape[0]):
        if not valid[p]:
            continue
        color = _person_color(p)
        # instance box
        cx, cy, w, h = kp_box[p, 0]
        d.rectangle([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    outline=color, width=line_width)
        # keypoint boxes
        for c in range(1, cfg.num_classes):
            if not kp_valid[p, c]:
                continue
            x, y, bw, bh = kp_box[p, c]
            d.rectangle([x - bw / 2, y - bh / 2, x + bw / 2, y + bh / 2],
                        outline=color, width=1)
        # limbs between assigned keypoint centers
        for s, t in cfg.edges:
            if s == 0 or not (kp_valid[p, s] and kp_valid[p, t]):
                continue
            d.line([tuple(kp_box[p, s, :2]), tuple(kp_box[p, t, :2])],
                   fill=color, width=line_width)
    return img
