"""Profiling and timing (counterpart of ``ppn_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` window, with CUDA activity on a
  card, written as a Chrome trace (Perfetto, ``chrome://tracing``).
- ``timeit``: steady-state seconds per call, ``iters`` calls enqueued back
  to back and the device synchronized once per repeat.
- ``device_latency_ms``: device ms per call as the slope between ``iters``
  and ``2·iters`` back-to-back calls, which cancels every fixed cost.
- ``latency_percentiles``: end-to-end ms per call, each call waited for.

The device synchronized is the one the call's output tensors lie on (the
host clock alone for CPU outputs).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ppn_tpu_torch import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block on ``device`` (``cuda`` unless asked otherwise: CPU
    and CUDA activity; ``cpu``: CPU activity only) and write
    ``<logdir>/trace.json``. Yields the profiler (``key_averages()`` sums
    the window by kernel)."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_device(out: Any):
    """The CUDA device of the first CUDA tensor in ``out``, or None."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def _sync(out: Any) -> None:
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, iters: int = 20, repeats: int = 3,
           warmup: int = 2) -> float:
    """Seconds per call at steady state (min over ``repeats`` runs of
    ``iters`` calls, each run ended by one synchronization)."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def device_latency_ms(body_fn: Callable, *args, iters: int = 32,
                      repeats: int = 3) -> float:
    """Per-call device latency in ms: the slope (t(2·iters) − t(iters)) /
    iters of runs of back-to-back calls, each run's time the min over
    ``repeats``. On a card the runs are timed with CUDA events on the
    current stream, which orders the calls; on the CPU with the host
    clock. The slope cancels every fixed per-run cost (event records,
    the first call's setup, the final synchronization). A call whose host
    work outlasts its device work measures the host: the stream then
    waits on the enqueue."""
    dev = _cuda_device(body_fn(*args))

    def run(n: int) -> float:
        best = float("inf")
        for _ in range(repeats):
            if dev is None:
                t0 = time.perf_counter()
                for _ in range(n):
                    body_fn(*args)
                best = min(best, 1e3 * (time.perf_counter() - t0))
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(n):
                body_fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            best = min(best, start.elapsed_time(end))
        return best

    t1 = run(iters)
    t2 = run(2 * iters)
    return max(0.0, (t2 - t1) / iters)


def latency_percentiles(fn: Callable, *args, calls: int = 50,
                        warmup: int = 3) -> dict:
    """Per-call end-to-end latency (call → results ready), ms."""
    for _ in range(warmup):
        _sync(fn(*args))
    lats = []
    for _ in range(calls):
        t0 = time.perf_counter()
        _sync(fn(*args))
        lats.append(time.perf_counter() - t0)
    lats = np.asarray(lats)
    return {
        "p50_ms": float(np.percentile(lats, 50) * 1000),
        "p90_ms": float(np.percentile(lats, 90) * 1000),
        "p99_ms": float(np.percentile(lats, 99) * 1000),
        "mean_ms": float(lats.mean() * 1000),
    }
