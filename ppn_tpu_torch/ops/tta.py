"""Horizontal-flip test-time augmentation, merged at the feature-map level
(port of ``ppn_tpu/ops/tta.py``).

The model runs on the image and on its mirror; the mirrored prediction is
mapped back and the two are averaged in pre-activation (logit) space, so one
post-process pass reads the merged map. The mirror mapping is exact algebra:

* grid columns reverse (W = W'·stride, so cell j ↔ W'−1−j);
* the x-offset group negates (σ(−t) = 1 − σ(t));
* keypoint classes swap left/right (``cfg.flip_pairs``; class 0 fixed);
* limb channels move to the mirrored edge and reverse their window's x
  axis (``local_grid_size`` is odd, so the reversal is exact).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.decode import split_feature_map


def class_permutation(cfg: PPNConfig) -> np.ndarray:
    """Permutation over the K+1 classes under horizontal flip (0 fixed)."""
    perm = list(range(cfg.num_classes))
    for a, b in cfg.flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return np.asarray(perm, np.int32)


def edge_permutation(cfg: PPNConfig) -> np.ndarray:
    """Permutation over the L edges under horizontal flip: edge (s, d) maps
    to (π(s), π(d)) with π the class permutation. Raises ``ValueError`` when
    the skeleton is not closed under the swap."""
    cperm = class_permutation(cfg)
    index = {e: i for i, e in enumerate(cfg.edges)}
    perm = np.empty(len(cfg.edges), np.int32)
    for i, (s, d) in enumerate(cfg.edges):
        mirrored = (int(cperm[s]), int(cperm[d]))
        if mirrored not in index:
            raise ValueError(
                f"edge {(s, d)} has no mirrored edge {mirrored} — the "
                "skeleton is not closed under flip_pairs")
        perm[i] = index[mirrored]
    return perm


@functools.lru_cache(maxsize=None)
def _permutations(cfg: PPNConfig, device: torch.device):
    """The class and edge permutations as index tensors on ``device``, made
    once: a fresh host-to-device copy per call would wait for the stream."""
    return (torch.from_numpy(class_permutation(cfg)).long().to(device),
            torch.from_numpy(edge_permutation(cfg)).long().to(device))


def flip_feature_map(cfg: PPNConfig, fm: torch.Tensor) -> torch.Tensor:
    """Map a raw (..., H', W', C) feature map predicted on a mirrored image
    back to the original frame. An involution: flip(flip(fm)) == fm."""
    raw = split_feature_map(cfg, fm)
    cperm, eperm = _permutations(cfg, fm.device)

    def grp(g, negate=False):
        g = torch.flip(g, dims=(-2,)).index_select(-1, cperm)  # W', L/R
        return -g if negate else g

    e = torch.flip(raw.e, dims=(-4,))             # W' reverse
    e = e.index_select(-3, eperm)                 # mirrored edges
    e = torch.flip(e, dims=(-1,))                 # window x reverse
    e_flat = e.reshape(*e.shape[:-3], cfg.num_limb_channels)
    return torch.cat([grp(raw.resp), grp(raw.conf), grp(raw.x, negate=True),
                      grp(raw.y), grp(raw.w), grp(raw.h), e_flat], dim=-1)


def mirror_images(images: torch.Tensor) -> torch.Tensor:
    """Mirror (B, H, W, C) pixels under the continuous x → W − x convention
    of the augmentation flip and the feature-map mirror: a bare flip maps
    index u → W−1−u, so the flipped image rolls right by one (u → W−u).
    Exactly involutive."""
    return torch.roll(torch.flip(images, dims=(2,)), 1, dims=2)


def merge_flip_tta(cfg: PPNConfig, fm: torch.Tensor,
                   fm_flipped: torch.Tensor) -> torch.Tensor:
    """Average the direct map with the mapped-back mirror prediction, in
    f32. ``fm_flipped`` is the raw model output on ``mirror_images(x)``."""
    fm = fm.to(torch.float32)
    return 0.5 * (fm + flip_feature_map(cfg, fm_flipped.to(torch.float32)))


def flip_tta_forward(cfg: PPNConfig, forward, images: torch.Tensor
                     ) -> torch.Tensor:
    """``forward`` (images → raw map) on the images and on their mirror,
    merged in f32 by ``merge_flip_tta``."""
    return merge_flip_tta(cfg, forward(images),
                          forward(mirror_images(images)))
