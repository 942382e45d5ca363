"""The port's profiling and debug utilities (ppn_tpu_torch/utils/
profiling.py, utils/debug.py) on the CPU: the timers return positive
seconds and milliseconds under the JAX package's keys, ``trace`` writes a
Chrome trace, and ``checking`` raises on a NaN forward naming a module and
restores the previous state on exit. The times themselves are host times
here; only a run on the card gives device times."""

import json

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.utils import debug, profiling
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def model():
    cfg = get_config("tiny_test")
    torch.manual_seed(0)
    return PoseProposalNet(cfg.model).eval(), cfg


def _matmul():
    a = torch.randn(64, 64)
    return lambda: a @ a


def test_timers_on_the_cpu():
    fn = _matmul()
    s = profiling.timeit(fn, iters=5, repeats=2, warmup=1)
    assert 0 < s < 1
    assert profiling.device_latency_ms(fn, iters=4, repeats=2) >= 0
    lat = profiling.latency_percentiles(fn, calls=10, warmup=1)
    assert set(lat) == {"p50_ms", "p90_ms", "p99_ms", "mean_ms"}
    assert all(v > 0 for v in lat.values())
    assert lat["p50_ms"] <= lat["p90_ms"] <= lat["p99_ms"]


def test_trace_writes_a_chrome_trace(tmp_path, model):
    net, cfg = model
    x = torch.zeros((1, *cfg.model.insize, 3), dtype=torch.uint8)
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with torch.no_grad():
            net(x)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_checking_raises_on_nan_and_restores(model):
    net, cfg = model
    nan = torch.full((1, *cfg.model.insize, 3), float("nan"))
    with torch.no_grad():
        net(nan)                       # off: a NaN passes through
        with debug.checking():
            assert torch.is_anomaly_enabled()
            with pytest.raises(FloatingPointError, match="Conv"):
                net(nan)
            net(torch.zeros_like(nan))     # finite: no check fires
            with debug.checking(nans=False):
                net(nan)               # off again inside
            with pytest.raises(FloatingPointError):
                net(nan)               # and back on
        assert not torch.is_anomaly_enabled()
        net(nan)                       # restored: off


def test_enable_checks(model):
    net, cfg = model
    nan = torch.full((1, *cfg.model.insize, 3), float("nan"))
    # the port runs eagerly: disable_jit has nothing to turn off
    debug.enable_checks(nans=False, disable_jit=True)
    assert not torch.is_anomaly_enabled()
    with debug.checking(nans=False):   # restores "off" after the test
        debug.enable_checks()
        with torch.no_grad(), pytest.raises(FloatingPointError):
            net(nan)
    with torch.no_grad():
        out = net(nan)
    assert np.isnan(out.numpy()).all()
