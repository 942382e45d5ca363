"""The card timers: device time by CUDA events (back to back, one call at
a time, or replayed from a CUDA graph), host time, latency percentiles,
and the card's line. ``chip_smoke.py``'s phases and the port's tools
(``tools/torch_kernel_times.py``, ``tools/torch_predict_profile.py``)
share them; each needs a CUDA device when called, none when imported."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def smi_line() -> str:
    """The card's ``nvidia-smi`` name and power limit line."""
    from ppn_tpu_torch.bench.suite import card

    return card("cuda")


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call with `reps` calls captured in a CUDA
    graph and replayed: each kernel and its launch, without the host's
    per-call Python work (which bounds `time_ms` for a kernel of a few tens
    of µs)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_times(fn, reps: int) -> list[float]:
    """The CUDA-event time around each of `reps` single calls (ms; for a
    call the host cannot keep ahead of, its enqueue time)."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def events_ms(fn, reps: int) -> float:
    """Median over `reps` single calls of the CUDA-event time around one
    call."""
    return statistics.median(event_times(fn, reps))


def percentiles_ms(fn, calls: int) -> tuple[float, float]:
    """p50 and p90 of the host-clock time of `calls` calls of `fn`, each
    ending with its results on the host."""
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        lat.append(1e3 * (time.perf_counter() - t0))
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 90)))


def host_us(fn, reps: int) -> float:
    """Mean host time of one call over `reps` calls enqueued back to back
    (µs; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def timed(fn) -> float:
    """Host seconds of one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
