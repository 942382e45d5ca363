"""Shared evaluation loop, PCKh and COCO OKS AP (port of
``ppn_tpu/eval/runner.py``).

``forward(images) -> People`` is a ``Predictor.predict``-style callable:
images in, host ``People`` (numpy, batched) out.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.data.pipeline import epoch_batches
from ppn_tpu_torch.eval.coco_eval import OKSEvaluator
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


def _image(people: People, i: int) -> People:
    """Row ``i`` of a batched host ``People``."""
    return People(*(np.asarray(x)[i] for x in people))


def add_pckh_batch(ev: PCKhEvaluator, people: People, batch: dict,
                   n_real: int) -> None:
    """Score one parsed batch into a PCKh evaluator."""
    for i in range(n_real):
        hs = (batch["headsizes"][i] if "headsizes" in batch
              else synthetic_headsizes(batch["bboxes"][i]))
        ev.add_image(_image(people, i), batch["keypoints"][i],
                     batch["visible"][i], batch["bboxes"][i],
                     batch["valid"][i], hs)


def _forward_batches(cfg: Config, forward: Callable[[np.ndarray], People],
                     dataset, max_images: int, batch_size: Optional[int]
                     ) -> Iterator[Tuple[People, dict, int]]:
    """Yield (host People, padded batch, n_real) over the first
    ``max_images`` of a dataset, in order; padded rows are never scored."""
    bs = batch_size or min(cfg.train.batch_size, 8)
    seen = 0
    for batch in epoch_batches(dataset, bs, rng=np.random.default_rng(0),
                               shuffle=False, drop_remainder=False):
        batch, n_real = pad_batch(batch, bs)
        yield forward(batch["image"]), batch, n_real
        seen += n_real
        if seen >= max_images:
            return


def evaluate_pckh(cfg: Config, forward: Callable[[np.ndarray], People],
                  dataset, max_images: int = 256,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
    """PCKh@0.5 over the first ``max_images`` of a dataset, in order."""
    ev = PCKhEvaluator(cfg.model)
    for people, batch, n_real in _forward_batches(
            cfg, forward, dataset, max_images, batch_size):
        add_pckh_batch(ev, people, batch, n_real)
    return ev.summarize()


def evaluate_oks(cfg: Config, forward: Callable[[np.ndarray], People],
                 dataset, max_images: int = 256,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
    """COCO-style OKS AP / AP50 / AP75 over the first ``max_images`` of a
    dataset, in order. GT areas come from the instance boxes, as in the
    reference."""
    ev = OKSEvaluator(cfg.model)
    for people, batch, n_real in _forward_batches(
            cfg, forward, dataset, max_images, batch_size):
        for i in range(n_real):
            areas = batch["bboxes"][i][:, 2] * batch["bboxes"][i][:, 3]
            ev.add_image(_image(people, i), batch["keypoints"][i],
                         batch["visible"][i], batch["valid"][i], areas)
    return ev.summarize()
