"""The trace reader over a synthetic profiler window: markers, span
records on the device and launches without a device record are handled
as the benchmark's arithmetic states."""

import pytest
import torch

from perfbench.yardstick import readers
from perfbench.yardstick.trace import (CALL, TRACE_MARKERS, WINDOW, Trace,
                                       category)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, annotation=False):
        self._v = (name, dev, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _window(lost: int = 0):
    ev = []
    for i in range(TRACE_MARKERS):              # markers before the window
        ev += [Ev("cudaLaunchKernel", CPU, i, 1, corr=i),
               Ev("marker", CUDA, 50 + i, 1, corr=i)]
    ev += [Ev(WINDOW, CPU, 1000, 10000, annotation=True),
           Ev(CALL, CPU, 1000, 9000, annotation=True),
           Ev(CALL, CUDA, 1100, 8000, annotation=True)]   # the span's record
    kernels = [("void ppn_post_kernel<>", 2000, 500), ("conv_fprop", 3000, 2000),
               ("elementwise_kernel", 5000, 1000),
               ("Memcpy HtoD (Pageable -> Device)", 1000, 1000),
               ("elementwise_kernel", 5500, 1000)]     # overlaps the one before
    for j, (name, start, dur) in enumerate(kernels):
        corr = 100 + j
        ev.append(Ev("cudaLaunchKernel", CPU, start - 50, 10, corr=corr))
        if j >= lost:
            ev.append(Ev(name, CUDA, start, dur, corr=corr))
    return ev


def test_busy_time_leaves_out_markers_and_span_records():
    tr = Trace(_window())
    assert tr.whole and tr.window_s == 10000 / 1e9
    assert tr.busy_s() == pytest.approx((500 + 1000 + 2000 + 1500) / 1e9)
    assert tr.count(lambda n: "ppn_post_kernel" in n) == 1
    obs = {"trace": tr, "calls": 1}
    assert readers.idle_pct(obs) == pytest.approx(50.0)
    assert readers.upload_ms(obs) == pytest.approx(1000 / 1e6)
    # non-conv: the two elementwise kernels, not the conv, copy or post
    assert readers.nonconv_ms(obs, "calls") == pytest.approx(2000 / 1e6)
    assert tr.device_ops(2)[0][0] == "conv_fprop"
    assert tr.idle_gaps()[0][0] == CALL


def test_a_window_with_a_launch_unrecorded_is_refused():
    tr = Trace(_window(lost=1))
    assert not tr.whole
    assert readers.idle_pct({"trace": tr}) is None
    assert readers.roofline_pct({"trace": tr, "card": "NVIDIA H100 80GB HBM3",
                                 "post_bytes_per_call": 1.0, "calls": 1},
                                "ppn_post_kernel", "post_bytes_per_call",
                                per_launch=False) is None


def test_categories_name_the_programs_kernels():
    assert category("void ppn_post_kernel<1024>") == "ppn_post_kernel"
    assert category("ppn_warp_kernel<3>") == "ppn_warp_kernel"
    assert category("Memset (Device)") == "copy"


def test_the_profiler_records_spans_and_no_operators():
    from perfbench.yardstick.trace import Profiler

    with Profiler("cpu") as prof:
        with torch.profiler.record_function(WINDOW):
            x = torch.ones(8, 8)
            for _ in range(3):
                x = x @ x + 1
    names = {e.name() for e in prof.events}
    assert WINDOW in names
    assert not any(n.startswith("aten::") for n in names), names
