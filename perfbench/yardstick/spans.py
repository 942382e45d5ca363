"""Readings of a traced window by the program's own spans: the device
operations that the host launched inside a span, and the kernel launches
inside the benchmark's calls.

Launches and other runtime calls are matched to their device records by
correlation id, as ``trace.py`` matches them; a runtime call belongs to a
span when it starts inside one of the span's records on the host clock.
That is a matter of time, not of thread: it holds where nothing else
launches while the span is open, as in a training step, whose backward
(run by autograd after the forward's spans have closed) falls outside
every forward span. Only the window's own spans count, and device
operations are clipped to the window, as ``trace.Trace`` clips them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.yardstick.trace import (CALL, KERNEL_LAUNCHES, WINDOW,
                                       _annotation)

# the program's span around each HRNet exchange unit's forward
# (``ppn_tpu_torch/nn/hrnet.py``)
FUSE = "ppn.hrnet.fuse"


class Spans:
    """The records of the named host ``spans``, the runtime calls and the
    device operations of one traced window, from the profiler's events."""

    def __init__(self, events, spans: Tuple[str, ...]):
        events = list(events)
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in events if e.device_type() != cuda]
        win = [e for e in host if e.name() == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"{len(win)} '{WINDOW}' spans in the trace")
        self.t0 = win[0].start_ns()
        self.t1 = self.t0 + win[0].duration_ns()
        inside = [e for e in host if self.t0 <= e.start_ns() <= self.t1]
        self.spans: Dict[str, List[Tuple[int, int]]] = {s: [] for s in spans}
        for e in inside:
            if e.name() in self.spans:
                self.spans[e.name()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        # runtime calls (launches, copies, sets): (name, start, correlation)
        self.calls = [(e.name(), e.start_ns(), e.correlation_id())
                      for e in inside if e.correlation_id()
                      and e.name() not in self.spans and not _annotation(e)]
        self.device: Dict[int, float] = {}
        for e in events:
            if e.device_type() != cuda or _annotation(e):
                continue
            a = max(e.start_ns(), self.t0)
            b = min(e.start_ns() + e.duration_ns(), self.t1)
            if b > a:
                self.device[e.correlation_id()] = (
                    self.device.get(e.correlation_id(), 0.0) + (b - a) / 1e9)

    def count(self, span: str) -> int:
        """The window's records of ``span``."""
        return len(self.spans[span])

    def _in(self, span: str) -> np.ndarray:
        """For each runtime call, whether it starts inside ``span``."""
        records = sorted(self.spans[span])
        if not records or not self.calls:
            return np.zeros(len(self.calls), bool)
        starts = np.array([a for a, _ in records], np.int64)
        ends = np.array([b for _, b in records], np.int64)
        at = np.array([t for _, t, _ in self.calls], np.int64)
        i = np.searchsorted(starts, at, side="right") - 1
        return (i >= 0) & (at <= ends[np.clip(i, 0, None)])

    def device_s(self, span: str) -> float:
        """Seconds of the device operations launched inside ``span``."""
        return sum(self.device.get(c, 0.0) for (_, _, c), ok in
                   zip(self.calls, self._in(span)) if ok)

    def launches(self, span: str) -> int:
        """Kernel launches inside ``span`` that have a device record."""
        return sum(1 for (n, _, c), ok in zip(self.calls, self._in(span))
                   if ok and n in KERNEL_LAUNCHES and c in self.device)


def _spans(obs: dict):
    """The window's ``Spans``, where the trace recorded every launch."""
    tr, sp = obs.get("trace"), obs.get("spans")
    return sp if tr is not None and tr.whole and sp is not None else None


def span_ms(obs: dict, span: str) -> Optional[float]:
    """Device ms a step of the operations launched inside ``span``; None
    where the window has no record of it."""
    sp = _spans(obs)
    if sp is None or not sp.count(span) or not obs.get("steps"):
        return None
    return 1e3 * sp.device_s(span) / obs["steps"]


def launches_per_step(obs: dict) -> Optional[float]:
    """Kernel launches with a device record inside the window's calls into
    the program, a step."""
    sp = _spans(obs)
    if sp is None or not sp.count(CALL) or not obs.get("steps"):
        return None
    return sp.launches(CALL) / obs["steps"]

