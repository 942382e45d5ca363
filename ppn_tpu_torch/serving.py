"""Micro-batching pose server (port of ``ppn_tpu/serving.py``).

Requests arrive one image at a time; the card serves best at a batch.
``PoseServer`` bridges the two:

* requests queue on the host; a dispatcher thread drains up to
  ``max_batch`` images, waiting at most ``batch_window_ms`` after the
  first request of a batch;
* the batch is zero-padded to the next power-of-two **bucket**, so only
  ``log2(max_batch) + 1`` batch shapes ever run (the JAX package compiles
  one program per shape; here the buckets keep cuDNN's algorithm choice
  and the results of a request independent of how many others shared its
  batch);
* one ``Predictor.predict`` (forward and one ``ppn_post_kernel`` launch on
  the card) runs per batch; every request resolves its own
  ``concurrent.futures.Future`` with a per-image ``People``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.ops.parse import People


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class PoseServer:
    """Threaded micro-batcher over a :class:`ppn_tpu_torch.inference.Predictor`.

    >>> server = PoseServer(Predictor.from_checkpoint(cfg, ckpt))
    >>> fut = server.submit(image)          # (H, W, 3) uint8/float32
    >>> people = fut.result()               # per-image People
    """

    def __init__(self, predictor: Predictor, max_batch: int = 32,
                 batch_window_ms: float = 5.0):
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        self._p = predictor
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self._q: "queue.SimpleQueue[Optional[Tuple[np.ndarray, Future]]]" \
            = queue.SimpleQueue()
        self._closed = False
        # submit() and close() race on _closed: without the lock a request
        # enqueued concurrently with close() could land after the shutdown
        # sentinel, and its Future would never resolve
        self._close_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batches_by_size: Dict[int, int] = {}
        self._images = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ppn-pose-server")
        self._thread.start()

    # ---- client API --------------------------------------------------------
    def submit(self, image: np.ndarray) -> "Future[People]":
        """Enqueue one (H, W, 3) image at the config's insize."""
        h, w = self._p.cfg.model.insize
        if image.shape != (h, w, 3):
            raise ValueError(f"expected ({h}, {w}, 3), got {image.shape}; "
                             "resize before submitting")
        fut: "Future[People]" = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put((np.asarray(image), fut))
        return fut

    def predict(self, image: np.ndarray,
                timeout: Optional[float] = None) -> People:
        return self.submit(image).result(timeout=timeout)

    def warmup(self, dtypes=(np.uint8, np.float32)) -> None:
        """Run every bucket shape once for each transport dtype a client may
        submit (uint8, the 4×-cheaper wire format; float32 in [0, 1]): the
        first call of a shape pays cuDNN's set-up and the caching
        allocator's growth, which would otherwise land on live requests."""
        h, w = self._p.cfg.model.insize
        for dt in dtypes:
            b = 1
            while True:
                self._p.predict(np.zeros((b, h, w, 3), dt))
                if b == self.max_batch:
                    break
                b *= 2

    def stats(self) -> Dict:
        with self._stats_lock:
            return {"images": self._images,
                    "batches_by_size": dict(self._batches_by_size)}

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()
        # The lock makes a post-sentinel enqueue impossible; should anything
        # be left behind, fail its Future instead of letting a timeout-less
        # .result() hang.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and item[1].set_running_or_notify_cancel():
                item[1].set_exception(RuntimeError("server closed"))

    def __enter__(self) -> "PoseServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- dispatcher --------------------------------------------------------
    def _drain(self) -> Optional[List[Tuple[np.ndarray, Future]]]:
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.monotonic() + self.batch_window_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:           # close() while draining: stop after
                self._q.put(None)     # this batch, re-post the sentinel
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if batch is None:
                return
            # a client may have cancelled its Future while it sat in the
            # queue (set_result would then raise and kill the dispatcher):
            # claim each future and drop the cancelled ones
            batch = [(img, fut) for img, fut in batch
                     if fut.set_running_or_notify_cancel()]
            if not batch:
                continue
            images = np.stack([img for img, _ in batch])
            n = images.shape[0]
            b = _bucket(n, self.max_batch)
            if b > n:                 # pad to the bucket's shape
                pad = np.zeros((b - n, *images.shape[1:]), images.dtype)
                images = np.concatenate([images, pad])
            try:
                people = self._p.predict(images)
            except Exception as e:    # noqa: BLE001 — resolve, don't die
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            with self._stats_lock:
                self._batches_by_size[b] = (
                    self._batches_by_size.get(b, 0) + 1)
                self._images += n
            for i, (_, fut) in enumerate(batch):
                fut.set_result(People(*(f[i] for f in people)))
