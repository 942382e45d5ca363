"""Readings of a ``torch.profiler`` window over the card.

Frozen from ``ppn_tpu_torch/utils/profiling.py`` (``window_busy_ms``,
``device_busy_ms``: ``TRACE_MARKERS``, ``KERNEL_LAUNCHES``, launches
matched to device records by correlation id) and
``tools/torch_predict_profile.py`` (``_category``) at commit
6c798b19f2f81ac884339f9f662eb9e6d03a12e7.

A traced window opens with ``TRACE_MARKERS`` tiny kernels that are not
counted: late in a process the profiler can leave a window's first kernels
without a device record, and the markers take that loss. A window whose
own kernel launches are not all recorded gives ``recorded`` under 1, and
the readings that need every kernel refuse it.

The window is the benchmark's ``record_function(WINDOW)`` span, each call
into the program a ``CALL`` span inside it; device operations (kernels,
copies, sets) count where they fall inside the window.

``Profiler`` records, of the host, only those spans (the user scope) and
the runtime calls that CUPTI reports (the launches the correlation match
needs, copies, synchronizations), and none of the program's operators:
recording every operator cost a training step about a fifth of its rate,
which the window's idle share and rate would have read as the program's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")
TRACE_MARKERS = 32
WINDOW = "perfbench.window"
CALL = "perfbench.call"       # one call into the program, inside the window
POST_KERNEL = "ppn_post_kernel"
WARP_KERNEL = "ppn_warp_kernel"


def category(name: str) -> str:
    """The program's two kernels by name, then ``_category``'s classes."""
    n = name.lower()
    if POST_KERNEL in n:
        return POST_KERNEL
    if WARP_KERNEL in n:
        return WARP_KERNEL
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "sm90_",
                            "implicit")):
        return "conv"
    if ("elementwise" in n or "vectorized" in n or "reduce" in n
            or "pool" in n):
        return "elementwise"
    return "other"


def _annotation(e) -> bool:
    """A span's own record (on the device too, where the profiler puts one
    for each span whose work ran there): never a device operation."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return (kind is not None and "user_annotation" in str(kind())) or \
        e.name().startswith("perfbench.")


class Profiler:
    """A kineto profiler over the card (and the host's runtime calls) that
    records of the host's ``record_function`` spans only the user scope;
    ``events`` holds its events after the block."""

    def __init__(self, device):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)

        self.acts = {ProfilerActivity.CPU}
        if torch.device(device).type == "cuda":
            self.acts.add(ProfilerActivity.CUDA)
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        self.events = None

    def __enter__(self) -> "Profiler":
        from torch._C._profiler import RecordScope
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.acts)
        _enable_profiler(self.config, self.acts, {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc) -> None:
        from torch.autograd import _disable_profiler

        self.events = list(_disable_profiler().events())


def open_window(device) -> None:
    """Launch the uncounted markers and wait for them."""
    marker = torch.zeros(1, device=device)
    for _ in range(TRACE_MARKERS):
        marker.add_(1.0)
    if marker.device.type == "cuda":
        torch.cuda.synchronize(device)


class Trace:
    """Device operations and host spans of one traced window, from the
    profiler's events."""

    def __init__(self, events):
        events = list(events)
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in events if e.device_type() != cuda]
        win = [e for e in host if e.name() == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"{len(win)} '{WINDOW}' spans in the trace")
        self.t0 = win[0].start_ns()
        self.t1 = self.t0 + win[0].duration_ns()
        launches = sorted((e for e in host if e.name() in KERNEL_LAUNCHES),
                          key=lambda e: e.start_ns())
        markers = {e.correlation_id() for e in launches[:TRACE_MARKERS]}
        dev = [e for e in events if e.device_type() == cuda
               and e.correlation_id() not in markers and not _annotation(e)]
        recorded = {e.correlation_id() for e in dev}
        inside = [e for e in launches[TRACE_MARKERS:]
                  if self.t0 <= e.start_ns() <= self.t1]
        self.recorded = (sum(e.correlation_id() in recorded for e in inside)
                         / len(inside) if inside else 0.0)
        # launches without a device record: (API, seconds into the window)
        self.unrecorded = [(e.name(), (e.start_ns() - self.t0) / 1e9)
                           for e in inside if e.correlation_id() not in recorded]
        ops = [(e.name(), max(e.start_ns(), self.t0),
                min(e.start_ns() + e.duration_ns(), self.t1)) for e in dev]
        self.ops = [o for o in ops if o[2] > o[1]]
        self.host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in host if e.duration_ns() > 0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def whole(self) -> bool:
        """Every kernel launched in the window has a device record."""
        return self.recorded == 1.0

    def seconds(self, keep: Callable[[str], bool] = lambda n: True) -> float:
        """Summed durations of the device operations whose name ``keep``s."""
        return sum(b - a for n, a, b in self.ops if keep(n)) / 1e9

    def count(self, keep: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.ops if keep(n))

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in self._busy_intervals()) / 1e9

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name."""
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return [[k[:120], v] for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 2000) -> List[list]:
        """Idle time of the device by what the host was doing: each of the
        ``longest`` gaps between device operations is charged to the
        innermost host span around its middle; the ``n`` largest sums."""
        edges = [self.t0]
        for a, b in self._busy_intervals():
            edges += [a, b]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        if not gaps:
            return []
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], np.int64)
        ends = np.array([h[2] for h in self.host], np.int64)
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            inside = [i for i in np.flatnonzero((starts <= mid) & (ends >= mid))
                      if names[i] != WINDOW]
            key = (names[max(inside, key=lambda i: starts[i])][:120]
                   if inside else "host outside any span")
            out[key] = out.get(key, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])[:n]]

