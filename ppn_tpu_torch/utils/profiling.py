"""Profiling and timing (counterpart of ``ppn_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` window, with CUDA activity on a
  card, written as a Chrome trace (Perfetto, ``chrome://tracing``).
- ``timeit``: steady-state seconds per call, ``iters`` calls enqueued back
  to back and the device synchronized once per repeat.
- ``device_latency_ms``: device ms per call as the slope between ``iters``
  and ``2·iters`` back-to-back calls, which cancels every fixed cost.
- ``device_busy_ms``: kernel time per call over a profiler window, by
  category (``window_busy_ms``); ``host_bound`` compares a call's time
  with it.
- ``latency_percentiles``: end-to-end ms per call, each call waited for.

The device synchronized is the one the call's output tensors lie on (the
host clock alone for CPU outputs).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ppn_tpu_torch import resolve_device

# host_bound: the share by which a call's time may exceed its device busy
# time before the host is said to bound it
HOST_BOUND_SLACK = 0.10
# the runtime calls that launch a kernel: each should have a device record
# in a profiler window
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")
# device_busy_ms: tiny kernels that open each profiler window and are not
# counted. Late in a process the profiler can leave a window's first
# kernels without a device record; these take the loss in place of fn's
TRACE_MARKERS = 32


@contextlib.contextmanager
def trace(logdir: Optional[str], device=None):
    """Profile the block on ``device`` (``cuda`` unless asked otherwise: CPU
    and CUDA activity; ``cpu``: CPU activity only) and write
    ``<logdir>/trace.json`` (no file when ``logdir`` is None). Yields the
    profiler (``key_averages()`` sums the window by kernel)."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if logdir is not None:
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


def window_busy_ms(prof, calls: int,
                   category: Optional[Callable[[str], str]] = None,
                   skip: int = 0) -> tuple[dict, float]:
    """A finished profiler window of ``calls`` calls after ``skip`` marker
    launches: (device ms per call of its kernels and copies by
    ``category(name)``, with their sum under ``"total"``; the share of its
    kernel launches, matched by correlation id, that have a device record).
    The first ``skip`` kernel launches and their records are left out."""
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    launches = sorted((e for e in events if e.device_type() != cuda
                       and e.name() in KERNEL_LAUNCHES),
                      key=lambda e: e.start_ns())
    markers = {e.correlation_id() for e in launches[:skip]}
    device = [e for e in events if e.device_type() == cuda
              and e.correlation_id() not in markers]
    out: dict = {}
    for e in device:
        key = category(e.name()) if category else "kernels"
        out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6 / calls
    out["total"] = sum(out.values())
    recorded = {e.correlation_id() for e in device}
    counted = [e.correlation_id() for e in launches[skip:]]
    share = (sum(c in recorded for c in counted) / len(counted)
             if counted else 1.0)
    return out, share


def device_busy_ms(fn: Callable, *args, device=None, calls: int = 3,
                   tries: int = 3,
                   category: Optional[Callable[[str], str]] = None
                   ) -> Optional[dict]:
    """Device time per call that kernels (and copies) take: their durations
    summed over a ``trace`` window of ``calls`` calls of ``fn(*args)`` on
    ``device`` (``cuda`` unless asked otherwise), by ``category(kernel
    name)``, with the sum of all under ``"total"``. Gaps between kernels
    count nothing, so unlike ``device_latency_ms``'s slope this is device
    work even where the host's enqueue bounds the call.

    The profiler can leave a window's first kernels without a device
    record (seen on an H100 late in a process, from one kernel to all of a
    short window's): each window opens with ``TRACE_MARKERS`` tiny kernels
    that are not counted, and a window whose own kernel launches are still
    not all recorded runs again, up to ``tries`` windows; the best is kept.
    ``"recorded"`` is its share of launches with a record (1.0: every
    kernel counted) and ``"windows"`` the windows run. None on the CPU,
    where no device work is recorded."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    marker = torch.zeros(1, device=dev)
    best = None
    for windows in range(1, tries + 1):
        with trace(None, dev) as prof:
            for _ in range(TRACE_MARKERS):
                marker.add_(1.0)
            torch.cuda.synchronize(dev)       # the window holds fn's work
            for _ in range(calls):
                fn(*args)
        out, share = window_busy_ms(prof, calls, category, TRACE_MARKERS)
        if best is None or share > best[1]:
            best = (out, share)
        if share == 1.0:
            break
    out, share = best
    out.update(recorded=share, windows=windows)
    return out


def host_bound(device_ms: float, busy: Optional[dict]) -> Optional[bool]:
    """Whether a call's time (a ``device_latency_ms`` slope or a host-clock
    step) exceeds its kernels' busy time by more than ``HOST_BOUND_SLACK``:
    the device then waits on the host. None without a busy time, or with
    one that misses kernels (``"recorded"`` under 1)."""
    if busy is None or busy["recorded"] < 1.0:
        return None
    return device_ms > (1.0 + HOST_BOUND_SLACK) * busy["total"]


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
