"""Synthetic stick-figure renders: the benchmark's frozen copy of
``ppn_tpu_torch/data/synthetic.py`` (``random_people``, ``_class_colors``,
``_glyphs``, ``render``) at commit 6c798b19f2f81ac884339f9f662eb9e6d03a12e7,
reading the geometry from a configuration file's ``model`` group instead of
the port's ``PPNConfig``.

Pure numpy and deterministic per (seed, index). ``render_set`` renders a
set across a pool of spawned worker processes and collates it as the port
transports images: uint8, rounded half up.
"""

from __future__ import annotations

import colorsys
import concurrent.futures
import multiprocessing
import os
from typing import Dict

import numpy as np

FIELDS = ("image", "keypoints", "visible", "bboxes", "valid")


def _stride(m: dict) -> tuple[float, float]:
    return (m["insize"][0] / m["outsize"][0], m["insize"][1] / m["outsize"][1])


def random_people(rng: np.random.Generator, m: dict, max_persons: int,
                  num_persons=None) -> Dict[str, np.ndarray]:
    """GT for one image: skeleton-aware random stick figures, 1 to
    ``max_persons`` of them (or ``num_persons``, an int or a (lo, hi)
    range), padded to ``max_persons`` slots."""
    K = len(m["keypoint_names"]) - 1
    img_h, img_w = m["insize"]
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

    hl, wl = m["local_grid_size"]
    sy, sx = _stride(m)
    max_step = 0.8 * min((hl // 2) * sy, (wl // 2) * sx)
    edges = [tuple(e) for e in m["edges"]]

    placed: list = []
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
        pos = np.zeros((K + 1, 2), np.float32)
        pos[0] = (cx, cy)
        for s, d in edges:
            step = min(rng.uniform(0.08, 0.3) * side, max_step)
            ang = rng.uniform(0, 2 * np.pi)
            pos[d] = pos[s] + step * np.asarray([np.cos(ang), np.sin(ang)])
        pts = np.clip(pos[1:], [2.0, 2.0],
                      [img_w - 3.0, img_h - 3.0]).astype(np.float32)
        vis = rng.random(K) < 0.85
        root = next(d for s, d in edges if s == 0)
        vis[root - 1] = True
        for s, d in edges:
            if s > 0 and not vis[s - 1]:
                vis[d - 1] = False
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

    return {"keypoints": keypoints, "visible": visible, "bboxes": bboxes,
            "valid": valid}


def _class_colors(k: int) -> np.ndarray:
    return np.asarray(
        [colorsys.hsv_to_rgb(i / max(k, 1), 1.0, 1.0) for i in range(k)],
        np.float32)


def _glyphs(m: dict) -> tuple:
    K = len(m["keypoint_names"]) - 1
    colors = _class_colors(K).copy()
    side = np.zeros(K, np.float32)
    for a, b in m["flip_pairs"]:
        colors[b - 1] = colors[a - 1]
        side[a - 1] = -1.0
        side[b - 1] = +1.0
    return colors, side


def render(m: dict, sample: Dict[str, np.ndarray]) -> np.ndarray:
    """A faint filled box per person plus one colour-coded disk per visible
    joint, float32 in [0, 1]."""
    img_h, img_w = m["insize"]
    K = len(m["keypoint_names"]) - 1
    img = np.zeros((img_h, img_w, 3), np.float32)
    colors, side = _glyphs(m)
    yy, xx = np.mgrid[0:img_h, 0:img_w].astype(np.float32)

    best_d = np.full((img_h, img_w), np.inf, np.float32)
    for p in range(sample["valid"].shape[0]):
        if not sample["valid"][p]:
            continue
        bcx, bcy, bw, bh = sample["bboxes"][p]
        inside = ((np.abs(xx - bcx) < bw / 2) & (np.abs(yy - bcy) < bh / 2))
        img[inside] += 0.15
    for p in range(sample["valid"].shape[0]):
        if not sample["valid"][p]:
            continue
        bcx, bcy, bw, bh = sample["bboxes"][p]
        radius = 0.5 * m["parts_scale"] * float(np.hypot(bw, bh))
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


def sample(m: dict, max_persons: int, seed: int, index: int,
           num_persons=None) -> Dict[str, np.ndarray]:
    """Image ``index`` of the set drawn from ``seed``: GT and uint8 pixels."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), int(index)]))
    out = random_people(rng, m, max_persons, num_persons)
    img = render(m, out)
    out["image"] = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return out


def render_set(m: dict, max_persons: int, seed: int, count: int,
               num_persons=None, workers: int = 8) -> Dict[str, np.ndarray]:
    """``count`` images of ``seed`` collated: image (count, H, W, 3) uint8,
    keypoints, visible, bboxes, valid. ``workers`` > 1 renders in that
    many spawned processes (at most the host's cores), all ended before
    it returns."""
    args = [(m, max_persons, seed, i, num_persons) for i in range(count)]
    workers = min(workers, os.cpu_count() or 1, count)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as pool:
            samples = list(pool.map(_sample_args, args))
    else:
        samples = [_sample_args(a) for a in args]
    return {k: np.stack([s[k] for s in samples]) for k in FIELDS}


def _sample_args(a) -> Dict[str, np.ndarray]:
    return sample(*a)
