"""Host input pipeline: dataset → fixed-shape numpy batches (port of
``ppn_tpu/data/pipeline.py``: ``collate``, ``epoch_batches``,
``infinite_batches`` and ``make_grain_loader``)."""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Sequence

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


def _epoch_indices(n: int, batch_size: int, *, rng: np.random.Generator,
                   shuffle: bool = True, drop_remainder: bool = True
                   ) -> Iterator[List[int]]:
    """The dataset rows of each batch of one epoch (``epoch_batches``'
    order)."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        yield idx[i:i + batch_size].tolist()


def _stream_indices(n: int, batch_size: int, *, seed: int = 0,
                    shuffle: bool = True) -> Iterator[List[int]]:
    """The dataset rows of each batch of ``infinite_batches``: epoch ``e``
    draws from ``SeedSequence([seed, e])``; fewer rows than a batch are
    drawn with replacement, one batch an epoch."""
    for epoch in itertools.count():
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        if n < batch_size:
            yield rng.choice(n, size=batch_size, replace=True).tolist()
        else:
            yield from _epoch_indices(n, batch_size, rng=rng, shuffle=shuffle)


def epoch_batches(dataset, batch_size: int, *, rng: np.random.Generator,
                  shuffle: bool = True, drop_remainder: bool = True,
                  image_uint8: bool = False
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of batches from a map-style dataset."""
    for rows in _epoch_indices(len(dataset), batch_size, rng=rng,
                               shuffle=shuffle,
                               drop_remainder=drop_remainder):
        yield collate([dataset[j] for j in rows], image_uint8=image_uint8)


def infinite_batches(dataset, batch_size: int, *, seed: int = 0,
                     shuffle: bool = True, image_uint8: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless stream of epochs (the train-loop feed).

    Datasets smaller than the batch are sampled with replacement (the
    overfit path), instead of drop_remainder yielding zero batches.
    """
    for rows in _stream_indices(len(dataset), batch_size, seed=seed,
                                shuffle=shuffle):
        yield collate([dataset[j] for j in rows], image_uint8=image_uint8)


def make_grain_loader(dataset, batch_size: int, *, seed: int = 0,
                      num_workers: int = 0,
                      num_epochs: Optional[int] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """The batches of the JAX function's path without grain: with
    ``num_epochs`` None, ``infinite_batches(dataset, batch_size,
    seed=seed)``; else ``num_epochs`` passes of ``epoch_batches`` with
    ``SeedSequence([seed, e])`` for pass ``e`` (float images, full
    batches only).

    Grain's own order (its ``IndexSampler`` permutation) is not
    reproduced: the GPU machine has no grain, and the JAX package
    documents this path for a machine without it. ``num_workers > 0``
    renders the samples and collates the batches in that many worker
    processes (``torch.utils.data.DataLoader``, started with ``spawn``:
    a forked child of a process that has initialised CUDA cannot use it,
    and fork is unsafe in a threaded process), which replay exactly those
    index lists in order, so the batches are bitwise those of
    ``num_workers=0`` for any dataset whose samples depend on their index
    alone. The dataset is pickled to the workers. A worker that dies
    raises ``RuntimeError`` in the caller."""
    n = len(dataset)
    if num_epochs is None:
        batches = _stream_indices(n, batch_size, seed=seed)
    else:
        batches = itertools.chain.from_iterable(
            _epoch_indices(n, batch_size, rng=np.random.default_rng(
                np.random.SeedSequence([seed, e])))
            for e in range(num_epochs))
    if num_workers <= 0:
        return (collate([dataset[j] for j in rows]) for rows in batches)
    from torch.utils.data import DataLoader

    # the iterator's finalizer stops and joins the workers
    return iter(DataLoader(
        dataset, batch_sampler=batches, collate_fn=collate,
        num_workers=num_workers, multiprocessing_context="spawn"))
