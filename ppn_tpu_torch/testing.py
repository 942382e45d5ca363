"""Seeded feature-map cases for holding the post-process kernel against its
plain version (and the plain version against the JAX package).

Made with numpy from a seed, so every side gets the same bytes:
  * ``normal``  — N(0, 2) logits everywhere: dense proposals, heavy NMS;
  * ``sparse``  — resp/conf logits near −5 with a few strong cells per
    class: few detections, most post-NMS scores exactly 0 (the seed tie
    order of empty slots);
  * ``ties``    — N(0, 2) rounded to integers: exact score ties between
    cells (NMS order, window first-max and seed ties by lower index).
"""

from __future__ import annotations

import numpy as np

from ppn_tpu_torch.configs import PPNConfig

KINDS = ("normal", "sparse", "ties")
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
    elif kind == "empty":
        fm[..., :2 * K1] = -20.0
    elif kind == "chain":
        fm = _chain(cfg, fm, rng)
    elif kind != "normal":
        raise ValueError(f"unknown case kind {kind!r}; have "
                         f"{KINDS + EDGE_KINDS}")
    return fm.astype(np.float32)


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
    arrays of the same sign pattern (0 where bitwise equal)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max(initial=0))
