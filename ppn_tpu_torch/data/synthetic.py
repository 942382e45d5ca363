"""Synthetic pose dataset — deterministic random stick-figures (a copy of
``ppn_tpu/data/synthetic.py``).

Pure numpy and deterministic per (seed, index): the same pixels and GT as
the JAX package's generator, which the tests check. The JAX package's
on-disk render cache (``materialize_collated``) is not carried over: it only
shortens the set-up of large synthetic runs.
"""

from __future__ import annotations

import colorsys
from typing import Dict

import numpy as np

from ppn_tpu_torch.configs import Config, PPNConfig


def random_people(
    rng: np.random.Generator,
    cfg: PPNConfig,
    max_persons: int,
    num_persons=None,
) -> Dict[str, np.ndarray]:
    """Sample GT for one image: skeleton-aware random stick figures.

    Joints are placed by walking the config's limb tree with bounded step
    sizes, so limb endpoints stay within the PPN local window.

    ``num_persons``: fixed int, ``None`` (uniform 1..max_persons), or an
    ``(lo, hi)`` pair for a uniform crowding range.

    Returns (keypoints, visible, bboxes, valid), padded to `max_persons`.
    """
    K = cfg.num_keypoints
    img_h, img_w = cfg.insize
    P = max_persons
    if num_persons is None:
        num_persons = int(rng.integers(1, P + 1))
    elif isinstance(num_persons, (tuple, list)):
        lo, hi = num_persons
        num_persons = int(rng.integers(lo, hi + 1))
    num_persons = min(num_persons, P)

    keypoints = np.zeros((P, K, 2), np.float32)
    visible = np.zeros((P, K), bool)
    bboxes = np.zeros((P, 4), np.float32)
    valid = np.zeros((P,), bool)

    # limb step ceiling: stay well inside the local window reach
    hl, wl = cfg.local_grid_size
    sy, sx = cfg.stride
    max_step = 0.8 * min((hl // 2) * sy, (wl // 2) * sx)

    placed: list = []  # (cx, cy, side) — avoid heavy person overlap
    for p in range(num_persons):
        side = rng.uniform(0.25, 0.6) * min(img_h, img_w)
        cx = rng.uniform(side / 2, img_w - side / 2)
        cy = rng.uniform(side / 2, img_h - side / 2)
        for _ in range(12):
            if all(np.hypot(cx - ox, cy - oy) > 0.45 * (side + os_)
                   for ox, oy, os_ in placed):
                break
            cx = rng.uniform(side / 2, img_w - side / 2)
            cy = rng.uniform(side / 2, img_h - side / 2)
        placed.append((cx, cy, side))
        # walk the limb tree from the instance center with bounded steps
        pos = np.zeros((K + 1, 2), np.float32)
        pos[0] = (cx, cy)
        for s, d in cfg.edges:
            step = min(rng.uniform(0.08, 0.3) * side, max_step)
            ang = rng.uniform(0, 2 * np.pi)
            pos[d] = pos[s] + step * np.asarray(
                [np.cos(ang), np.sin(ang)])
        pts = np.clip(pos[1:], [2.0, 2.0],
                      [img_w - 3.0, img_h - 3.0]).astype(np.float32)
        # Annotation dropout is subtree-consistent: an unannotated joint
        # hides its distal subtree too; the root's first child is always
        # annotated.
        vis = rng.random(K) < 0.85
        root = next(d for s, d in cfg.edges if s == 0)
        vis[root - 1] = True
        for s, d in cfg.edges:
            if s > 0 and not vis[s - 1]:
                vis[d - 1] = False
        # Tight person box around visible joints, padded 10%.
        vpts = pts[vis]
        x0, y0 = vpts.min(axis=0)
        x1, y1 = vpts.max(axis=0)
        bw = max(x1 - x0, 8.0) * 1.1
        bh = max(y1 - y0, 8.0) * 1.1
        bcx, bcy = (x0 + x1) / 2, (y0 + y1) / 2

        keypoints[p] = pts
        visible[p] = vis
        bboxes[p] = (bcx, bcy, bw, bh)
        valid[p] = True

    return {
        "keypoints": keypoints,
        "visible": visible,
        "bboxes": bboxes,
        "valid": valid,
    }


def _class_colors(k: int) -> np.ndarray:
    """K visually-distinct RGB colors in [0,1]."""
    return np.asarray(
        [colorsys.hsv_to_rgb(i / max(k, 1), 1.0, 1.0) for i in range(k)],
        np.float32)


def _glyphs(cfg: PPNConfig) -> tuple:
    """(colors, side) per keypoint: both members of a flip pair share one
    color, and chirality is a dark dot offset horizontally (+x for one
    member, −x for the other)."""
    colors = _class_colors(cfg.num_keypoints).copy()
    side = np.zeros(cfg.num_keypoints, np.float32)
    for a, b in cfg.flip_pairs:
        colors[b - 1] = colors[a - 1]
        side[a - 1] = -1.0
        side[b - 1] = +1.0
    return colors, side


def render(cfg: PPNConfig, sample: Dict[str, np.ndarray]) -> np.ndarray:
    """Render GT: a faint filled person box plus one color-coded disk per
    visible joint (paired joints share a color and carry a mirrored
    chirality dot)."""
    img_h, img_w = cfg.insize
    K = cfg.num_keypoints
    img = np.zeros((img_h, img_w, 3), np.float32)
    colors, side = _glyphs(cfg)
    yy, xx = np.mgrid[0:img_h, 0:img_w].astype(np.float32)

    # Box fills are additive and overlapping glyphs resolve by
    # nearest-joint-wins, so the image mirrors exactly under a flip of the GT.
    best_d = np.full((img_h, img_w), np.inf, np.float32)
    for p in range(sample["valid"].shape[0]):
        if not sample["valid"][p]:
            continue
        bcx, bcy, bw, bh = sample["bboxes"][p]
        inside = ((np.abs(xx - bcx) < bw / 2) &
                  (np.abs(yy - bcy) < bh / 2))
        img[inside] += 0.15
    for p in range(sample["valid"].shape[0]):
        if not sample["valid"][p]:
            continue
        bcx, bcy, bw, bh = sample["bboxes"][p]
        radius = 0.5 * cfg.parts_scale * float(np.hypot(bw, bh))
        radius = max(radius, 3.0)
        for k in range(K):
            if not sample["visible"][p, k]:
                continue
            x, y = sample["keypoints"][p, k]
            d = (xx - x) ** 2 + (yy - y) ** 2
            win = (d < radius ** 2) & (d < best_d)
            img[win] = colors[k]
            if side[k]:
                dot = ((xx - (x + side[k] * 0.55 * radius)) ** 2
                       + (yy - y) ** 2 < (0.35 * radius) ** 2)
                img[dot & win] = 0.0
            best_d[win] = d[win]
    return np.clip(img, 0.0, 1.0)


class SyntheticPoseDataset:
    """Map-style dataset yielding (image, gt-dict); deterministic per index."""

    def __init__(self, cfg: Config, size: int = 1024, seed: int = 0,
                 num_persons: int | None = None, cache: bool = False):
        self.cfg = cfg
        self.size = size
        self.seed = seed
        self.num_persons = num_persons
        # cached samples hold uint8 pixels (collate's transport rounding)
        self._cache: Dict[int, Dict[str, np.ndarray]] | None = (
            {} if cache else None)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx = idx % self.size
        if self._cache is not None and idx in self._cache:
            return dict(self._cache[idx])
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx]))
        sample = random_people(
            rng, self.cfg.model, self.cfg.data.max_persons, self.num_persons)
        sample["image"] = render(self.cfg.model, sample)
        if self._cache is not None:
            cached = dict(sample)
            cached["image"] = np.clip(
                sample["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            self._cache[idx] = cached
            return dict(cached)
        return sample


def heldout_dataset(cfg: Config, num_persons=None) -> SyntheticPoseDataset:
    """The held-out synthetic eval set (128 images, seed 10000, uint8
    pixels) of the JAX package's ``apps/train.py make_datasets`` — the
    protocol the committed snapshots' PCKh is pinned on."""
    return SyntheticPoseDataset(cfg, size=128, seed=10_000, cache=True,
                                num_persons=num_persons)
