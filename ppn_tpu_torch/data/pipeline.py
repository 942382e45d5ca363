"""Host input pipeline: dataset → fixed-shape numpy batches (port of
``ppn_tpu/data/pipeline.py`` ``collate`` and ``epoch_batches``)."""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

_BATCH_KEYS = ("image", "keypoints", "visible", "bboxes", "valid")


def collate(samples: Sequence[Dict[str, np.ndarray]],
            image_uint8: bool = False) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into one batch dict.

    image_uint8=True quantizes float images to uint8 for transport; the
    model normalizes on the device.
    """
    out = {}
    for k in _BATCH_KEYS:
        v = np.stack([np.asarray(s[k]) for s in samples])
        if v.dtype.kind == "f":
            v = v.astype(np.float32)
        if k == "image" and image_uint8 and v.dtype != np.uint8:
            v = np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
        out[k] = v
    # optional extras (eval metadata) pass through when every sample has them
    for k in samples[0]:
        if k not in _BATCH_KEYS:
            try:
                out[k] = np.stack([np.asarray(s[k]) for s in samples])
            except ValueError:
                pass
    return out


def epoch_batches(dataset, batch_size: int, *, rng: np.random.Generator,
                  shuffle: bool = True, drop_remainder: bool = True,
                  image_uint8: bool = False
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of batches from a map-style dataset."""
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    stop = (len(idx) // batch_size) * batch_size if drop_remainder else len(idx)
    for i in range(0, stop, batch_size):
        yield collate([dataset[int(j)] for j in idx[i:i + batch_size]],
                      image_uint8=image_uint8)
