"""The bytes the post-process must move for a feature map: a frozen copy of
``ppn_tpu_torch/ops/cuda_post.py`` ``needed_bytes`` and ``output_bytes`` at
commit 6c798b19f2f81ac884339f9f662eb9e6d03a12e7, over the reference's
decode, NMS and parse (``reference/post.py``). Applied to the reference's
own map, the bound reads the same work whatever implements it.

Each byte is read once: the 6·(K+1) proposal channels of every cell; 4
bytes for each (image, cell, limb, offset) whose neighbour lies in the
frame and either keeps a post-NMS score > 0 or belongs to a row the limb
walk consults that holds such a destination; and the outputs.
"""

from __future__ import annotations

import torch

from perfbench.reference.post import decode, nms, parse, window_tables


def output_bytes(g) -> int:
    P, K1 = g.max_instances, g.num_classes
    return P * K1 * (2 * 4 + 4 * 4 + 4 + 1) + P * (1 + 4)


def needed_bytes(g, feature_map: torch.Tensor) -> int:
    B = feature_map.shape[0]
    H, W = g.outsize
    N, K1 = H * W, g.num_classes
    dev = feature_map.device
    act, props = decode(g, feature_map)
    score = nms(g, props)
    kept = score.reshape(B, N, K1)[:, :, [d for _, d in g.edges]] > 0.0
    _, nbrv, nbrc = window_tables(g)
    inside = torch.from_numpy(nbrv).to(dev)[None, :, :, None]
    toward_kept = inside & kept[:, torch.from_numpy(nbrc).to(dev)]
    ppl = parse(g, act, props, score)
    cell = ppl.kp_cell[..., 0].long() * W + ppl.kp_cell[..., 1].long()
    consulted = torch.zeros_like(kept)
    for l, (s, _) in enumerate(g.edges):
        b, q = torch.nonzero(ppl.kp_score[:, :, s] > 0.0, as_tuple=True)
        consulted[b, cell[b, q, s], l] = True
    scanned = consulted & toward_kept.any(dim=1)
    reads = toward_kept | (inside & scanned[:, None])
    return B * (N * 6 * K1 * 4 + output_bytes(g)) + 4 * int(reads.sum())
