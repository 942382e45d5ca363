"""Seeded feature-map cases for holding the post-process kernel against its
plain version (and the plain version against the JAX package).

Made with numpy from a seed, so every side gets the same bytes:
  * ``normal``  — N(0, 2) logits everywhere: dense proposals, heavy NMS;
  * ``sparse``  — resp/conf logits near −5 with a few strong cells per
    class: few detections, most post-NMS scores exactly 0 (the seed tie
    order of empty slots);
  * ``ties``    — N(0, 2) rounded to integers: exact score ties between
    cells (NMS order, window first-max and seed ties by lower index);
  * ``nan``     — the ``normal`` map with 1% of the limb logits and a few
    proposal logits (scores and boxes) set to NaN: a window holding a NaN
    at an in-frame offset has no winner, a NaN score is no candidate and a
    NaN box overlaps nothing.

``nan_window_case`` is the hand-made case of one NaN limb logit beside the
winner its window would otherwise have.

``write_mpii_set`` and ``write_coco_set`` write dataset trees in the MPII
JSON and COCO ``person_keypoints`` layouts from synthetic samples, so the
file loaders run on known GT with no dataset at hand.

``replacing_config`` changes fields of every config ``get_config`` gives
while it is open, for the tools that take no flag for them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np

from ppn_tpu_torch.configs import PPNConfig

KINDS = ("normal", "sparse", "ties", "nan")
EDGE_KINDS = ("empty", "chain")


def feature_map_case(cfg: PPNConfig, batch: int, seed: int,
                     kind: str = "normal") -> np.ndarray:
    """(batch, H', W', C) float32 logits of one kind."""
    rng = np.random.default_rng(seed)
    H, W = cfg.outsize
    K1 = cfg.num_classes
    fm = rng.normal(0.0, 2.0, (batch, H, W, cfg.num_channels))
    if kind == "sparse":
        fm[..., :2 * K1] = rng.normal(-5.0, 1.5, (batch, H, W, 2 * K1))
        hits = max(1, (H * W) // 48)
        for b in range(batch):
            for c in range(K1):
                cells = rng.choice(H * W, size=hits, replace=False)
                fm[b, cells // W, cells % W, c] = 4.0
                fm[b, cells // W, cells % W, K1 + c] = 4.0
    elif kind == "ties":
        fm = np.round(fm)
    elif kind == "nan":
        limbs = fm[..., 6 * K1:]
        limbs[rng.random(limbs.shape) < 0.01] = np.nan
        per_image = H * W * 6 * K1
        for b in range(batch):
            t = rng.choice(per_image, size=max(2, per_image // 500),
                           replace=False)
            cell, ch = t // (6 * K1), t % (6 * K1)
            fm[b, cell // W, cell % W, ch] = np.nan
    elif kind == "empty":
        fm[..., :2 * K1] = -20.0
    elif kind == "chain":
        fm = _chain(cfg, fm, rng)
    elif kind != "normal":
        raise ValueError(f"unknown case kind {kind!r}; have "
                         f"{KINDS + EDGE_KINDS}")
    return fm.astype(np.float32)


def nan_window_case(cfg: PPNConfig) -> np.ndarray:
    """(1, H', W', C) map: the instance kept at cell (0, 0) and the
    destination class of its first limb kept at (0, 1) and (1, 1); that
    limb's logits from (0, 0) are −3, except NaN toward (0, 1) and 3 toward
    (1, 1). The NaN leaves the row without a winner, so slot 0 gets no
    keypoint of that class (cell (0, 0), score 0), though (1, 1) alone
    would win. Boxes are sub-pixel, so NMS keeps every candidate."""
    H, W = cfg.outsize
    Hl, Wl = cfg.local_grid_size
    K1, NW = cfg.num_classes, Hl * Wl
    if H < 2 or W < 2 or Hl < 3 or Wl < 3:
        raise ValueError("nan_window_case needs a 2×2 grid and a 3×3 window")
    fm = np.full((1, H, W, cfg.num_channels), -3.0, np.float32)
    fm[..., :2 * K1] = -20.0                  # no candidate anywhere ...
    fm[..., 4 * K1:6 * K1] = -5.0             # ... and sub-pixel boxes
    limb = next(i for i, (s, _) in enumerate(cfg.edges) if s == 0)
    d = cfg.edges[limb][1]
    for y, x, c in ((0, 0, 0), (0, 1, d), (1, 1, d)):
        fm[0, y, x, [c, K1 + c]] = 20.0
    ch, cw = Hl // 2, Wl // 2
    e = fm[0, 0, 0, 6 * K1 + limb * NW:6 * K1 + (limb + 1) * NW]
    e[ch * Wl + cw + 1] = np.nan              # toward (0, 1)
    e[(ch + 1) * Wl + cw + 1] = 3.0           # toward (1, 1)
    return fm


def _size_logit(cfg: PPNConfig, frac: float) -> float:
    """The w/h logit that decodes to ``frac`` of the input side."""
    if cfg.size_activation == "exp":
        return float(np.log(frac))
    return float(np.log(frac / (1.0 - frac)))


def _chain(cfg: PPNConfig, fm: np.ndarray, rng) -> np.ndarray:
    """The ``chain`` case on top of random limb logits ``fm``."""
    B, H, W = fm.shape[:3]
    K1 = cfg.num_classes
    sy, sx = cfg.stride
    img_h, img_w = cfg.insize
    t = cfg.nms_thresh
    # same-height boxes dx apart have IoU (w − dx)/(w + dx): above t at one
    # stride, at most t at two; w is the geometric mean of those limits
    w = np.sqrt(2.0) * sx * (1.0 + t) / (1.0 - t)
    h = 0.5 * sy                        # rows apart never touch
    if w >= img_w:
        raise ValueError(f"{cfg.outsize} grid too small for the chain case")
    for b in range(B):
        rank = (rng.permutation(H)[:, None] * W
                + np.arange(W)[None, :])    # score rank of each cell
        logit = 6.0 - 0.02 * rank           # σ(·)² distinct, > 0.9
        fm[b, :, :, :K1] = logit[..., None]
        fm[b, :, :, K1:2 * K1] = logit[..., None]
        fm[b, :, :, 2 * K1:3 * K1] = rng.normal(0.0, 0.05, (H, W, K1))
        fm[b, :, :, 3 * K1:4 * K1] = 0.0    # rows aligned: flat boxes
        fm[b, :, :, 4 * K1:5 * K1] = _size_logit(cfg, w / img_w)
        fm[b, :, :, 5 * K1:6 * K1] = _size_logit(cfg, h / img_h)
    return fm


def max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two float32
    arrays of the same sign pattern (0 where bitwise equal, and where both
    are NaN, whatever their payloads); a NaN against a number counts as
    2**32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    if (na != nb).any():
        return 2 ** 32
    ai = np.where(na, np.float32(0), a).view(np.int32).astype(np.int64)
    bi = np.where(nb, np.float32(0), b).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max(initial=0))


def _save_image(pixels: np.ndarray, path: str) -> None:
    """uint8 (H, W, 3) → an image file; a ``.jpg`` at quality 95, every
    other option at PIL's default."""
    from PIL import Image

    opts = {"quality": 95} if path.endswith(".jpg") else {}
    Image.fromarray(pixels).save(path, **opts)


def _enlarged(pixels: np.ndarray, scale: float) -> np.ndarray:
    """uint8 (H, W, 3) enlarged by ``scale`` (PIL bilinear; as it is at
    1)."""
    if scale == 1.0:
        return pixels
    from PIL import Image

    H, W = pixels.shape[:2]
    size = (round(W * scale), round(H * scale))
    return np.asarray(Image.fromarray(pixels).resize(size, Image.BILINEAR))


def _dump(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write_mpii_set(cfg, root: str, splits: dict, ext: str = "png",
                   scale: float = 1.0) -> None:
    """An MPII tree under ``root``: for each ``split: (dataset, n, first)``
    the first ``n`` samples of a uint8 synthetic dataset as
    ``images/{first + i:05d}.{ext}`` and ``annot/{split}.json``, one record
    per valid person in slot order. The joints go back to MPII's order
    (invisible ones keep their coordinates); ``center`` is the box center
    and ``scale`` its longer side / 200 (MPII's square of side 200·scale);
    the head box is a square whose 0.6 · diagonal is 0.2 · the box
    diagonal, ``eval/runner.synthetic_headsizes``. ``scale`` > 1 writes
    each image enlarged by that factor (PIL bilinear) with every
    coordinate and size scaled alike, so that a loader's resize to the
    model input has work to do."""
    from ppn_tpu_torch.data.mpii import _remap_indices

    perm = _remap_indices(cfg)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for split, (dataset, n, first) in splits.items():
        records = []
        for i in range(n):
            s = dataset[i]
            name = f"{first + i:05d}.{ext}"
            _save_image(_enlarged(s["image"], scale),
                        os.path.join(root, "images", name))
            for p in np.flatnonzero(s["valid"]):
                joints = np.zeros((16, 2), np.float32)
                joints_vis = np.zeros(16, np.int64)
                joints[perm] = s["keypoints"][p] * np.float32(scale)
                joints_vis[perm] = s["visible"][p]
                cx, cy, w, h = (s["bboxes"][p] * np.float32(scale)).tolist()
                d = 0.2 * float(np.hypot(w, h)) / 0.6 / np.sqrt(2.0)
                records.append({
                    "image": name, "joints": joints.tolist(),
                    "joints_vis": joints_vis.tolist(), "center": [cx, cy],
                    "scale": max(w, h) / 200, "headbox": [0.0, 0.0, d, d]})
        _dump(records, os.path.join(root, "annot", f"{split}.json"))


def write_coco_set(root: str, dataset, n: int, ext: str = "png") -> None:
    """A COCO tree under ``root``: the first ``n`` samples of a uint8
    synthetic dataset as ``{i:012d}.{ext}`` in both ``train2017/`` and
    ``val2017/``, and one identical ``annotations/person_keypoints_*.json``
    for each, one annotation per valid person (``[x, y, v]`` keypoints with
    v = 2 where visible and 0, at (0, 0), where not; ``bbox`` the corner
    form of the box, ``area`` its w·h)."""
    images, anns = [], []
    for i in range(n):
        s = dataset[i]
        name = f"{i:012d}.{ext}"
        for d in ("train2017", "val2017"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
            _save_image(s["image"], os.path.join(root, d, name))
        H, W = s["image"].shape[:2]
        images.append({"id": i, "file_name": name, "width": W, "height": H})
        for p in np.flatnonzero(s["valid"]):
            kps = []
            for (x, y), v in zip(s["keypoints"][p].tolist(),
                                 s["visible"][p].tolist()):
                kps += [x, y, 2] if v else [0.0, 0.0, 0]
            cx, cy, w, h = s["bboxes"][p].tolist()
            anns.append({
                "id": len(anns) + 1, "image_id": i, "category_id": 1,
                "keypoints": kps, "num_keypoints": int(s["visible"][p].sum()),
                "bbox": [cx - w / 2, cy - h / 2, w, h], "area": w * h,
                "iscrowd": 0})
    blob = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}
    for split in ("train2017", "val2017"):
        _dump(blob, os.path.join(root, "annotations",
                                 f"person_keypoints_{split}.json"))


@contextlib.contextmanager
def replacing_config(**sections):
    """While open, ``ppn_tpu_torch.configs.get_config`` gives each config
    with the fields of each named section replaced, as in
    ``replacing_config(model={"backbone": "resnet34"})`` or
    ``replacing_config(train={"dtype": "float32"})``. The tools read their
    config through it at call time, so this sets what they take no flag
    for."""
    from ppn_tpu_torch import configs

    get = configs.get_config

    def patched(name, **overrides):
        cfg = get(name, **overrides)
        return dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), **v)
            for k, v in sections.items()})

    configs.get_config = patched
    try:
        yield
    finally:
        configs.get_config = get
