"""Shared PCKh evaluation loop (port of ``ppn_tpu/eval/runner.py``).

``forward(images) -> People`` is a ``Predictor.predict``-style callable:
images in, host ``People`` (numpy, batched) out.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.data.pipeline import epoch_batches
from ppn_tpu_torch.eval.pckh import PCKhEvaluator
from ppn_tpu_torch.ops.parse import People


def synthetic_headsizes(bboxes: np.ndarray) -> np.ndarray:
    """Pseudo head-segment size for data without head boxes: the
    keypoint-box scale (0.2 · instance diagonal)."""
    return 0.2 * np.hypot(bboxes[..., 2], bboxes[..., 3])


def pad_batch(batch: dict, bs: int) -> Tuple[dict, int]:
    """Pad a trailing partial batch to the fixed batch size by repeating
    its first row. Returns (padded batch, n_real); padded rows are never
    scored."""
    n_real = batch["image"].shape[0]
    if n_real < bs:
        batch = {k: np.concatenate(
            [v, np.repeat(v[:1], bs - n_real, axis=0)])
            for k, v in batch.items()}
    return batch, n_real


def add_pckh_batch(ev: PCKhEvaluator, people: People, batch: dict,
                   n_real: int) -> None:
    """Score one parsed batch into a PCKh evaluator."""
    for i in range(n_real):
        one = People(*(np.asarray(x)[i] for x in people))
        hs = (batch["headsizes"][i] if "headsizes" in batch
              else synthetic_headsizes(batch["bboxes"][i]))
        ev.add_image(one, batch["keypoints"][i], batch["visible"][i],
                     batch["bboxes"][i], batch["valid"][i], hs)


def evaluate_pckh(cfg: Config, forward: Callable[[np.ndarray], People],
                  dataset, max_images: int = 256,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
    """PCKh@0.5 over the first ``max_images`` of a dataset, in order."""
    ev = PCKhEvaluator(cfg.model)
    bs = batch_size or min(cfg.train.batch_size, 8)
    seen = 0
    for batch in epoch_batches(dataset, bs, rng=np.random.default_rng(0),
                               shuffle=False, drop_remainder=False):
        batch, n_real = pad_batch(batch, bs)
        add_pckh_batch(ev, forward(batch["image"]), batch, n_real)
        seen += n_real
        if seen >= max_images:
            break
    return ev.summarize()
