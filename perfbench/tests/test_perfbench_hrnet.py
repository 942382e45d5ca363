"""The HRNet-W32 cell's pieces on the CPU: the plain reference
(``reference/hrnet.py``) against the program's plain path at 64², in
float32, in eval and training mode, with its recomputing backward; its
FLOP count against the program's own count; its seeded weights against
the program's module tree; the entry driven end to end at tiny size."""

import dataclasses
import json

import pytest
import torch

from perfbench import faults, harness
from perfbench.entries import train_hrnet
from perfbench.reference import hrnet as refhrnet
from perfbench.tests import tiny
from perfbench.yardstick import flops_hrnet, synthetic, weights_hrnet

CFG = harness.ROOT / "perfbench/configs/mpii_hrw32_384.json"
TRAFFIC = {"batch": 2, "steps_per_call": 4, "rows": 8, "renders": 4}


def _tiny_file() -> dict:
    """The cell's configuration file at tiny_test's geometry (64², 2×2 grid,
    3×3 window, 4 person slots), the published widths kept."""
    from ppn_tpu_torch.configs import get_config

    cfg = json.loads(CFG.read_text())
    d = json.loads(json.dumps(dataclasses.asdict(get_config("tiny_test"))))
    for k in ("insize", "outsize", "local_grid_size", "max_instances"):
        cfg["model"][k] = d["model"][k]
    cfg["data"] = d["data"]
    cfg["train"] = dict(d["train"], dtype="float32")
    cfg["program_config"] = "tiny_test"
    return cfg


def _program_model(cfg: dict, w):
    from ppn_tpu_torch.nn.model import PoseProposalNet

    pc = tiny.program_config(cfg)
    model = PoseProposalNet(pc.model, dtype=torch.float32)
    model.load_state_dict(w)
    return model


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny_file()
    w = weights_hrnet.seeded(cfg["model"], 11, "cpu")
    gen = torch.Generator().manual_seed(3)
    for k in w:
        if k.endswith("running_mean"):
            w[k] = 0.1 * torch.randn(w[k].shape, generator=gen)
        if k.endswith("running_var"):
            w[k] = 1.0 + torch.rand(w[k].shape, generator=gen)
    data = synthetic.render_set(cfg["model"], cfg["data"]["max_persons"], 5,
                                2, workers=1)
    return cfg, w, torch.from_numpy(data["image"])


@pytest.mark.parametrize("train", [False, True])
def test_reference_equals_the_programs_plain_path(setup, train):
    cfg, w, images = setup
    model = _program_model(cfg, w).train(train)
    stats = {k: w[k].clone() for k in refhrnet.buffer_names(cfg["model"])}
    with torch.no_grad():
        want = model(images)
        got = refhrnet.forward(cfg["model"], w, images, train=train,
                               stats=stats)
    # eval: the same operations in the same order; training: the stride-32
    # layers' statistics over 8 values a channel, where the program's
    # E[x²] − E[x]² and the reference's two-pass variance part by a few
    # parts in 1e4 (tests/test_torch_hrnet.py measures 1.1e-4)
    tol = 1e-3 if train else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(
        want.abs().max()))
    if train:
        sd = model.state_dict()
        for k, v in stats.items():
            torch.testing.assert_close(v, sd[k], rtol=2e-4, atol=2e-4)


def test_recomputed_backward_is_the_same_arithmetic(setup):
    """``checkpoint=True`` gives the gradients and running statistics of
    the plain backward, the statistics updated once."""
    cfg, w, images = setup
    out = []
    for ckpt in (False, True):
        p = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                         "running_var")))
             for k, v in w.items()}
        stats = {k: w[k].clone() for k in refhrnet.buffer_names(cfg["model"])}
        fm = refhrnet.forward(cfg["model"], p, images, train=True,
                              stats=stats, checkpoint=ckpt)
        names = [k for k in p if p[k].requires_grad]
        grads = torch.autograd.grad(fm.square().sum(), [p[k] for k in names])
        out.append((fm.detach(), dict(zip(names, grads)), stats))
    (fa, ga, sa), (fb, gb, sb) = out
    assert torch.equal(fa, fb)
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=1e-5, atol=1e-6)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_flops_equal_the_programs_count():
    from ppn_tpu_torch.bench.suite import forward_flops
    from ppn_tpu_torch.configs import get_config

    m = harness.load_json(CFG)["model"]
    want = forward_flops(get_config("mpii_hrw32_384"), 1)
    assert flops_hrnet.forward_flops(m) == want == 55_346_429_952
    assert flops_hrnet.train_flops(m) == 3 * want


def test_seeded_weights_load_into_the_program_by_name():
    from ppn_tpu_torch.nn.model import PoseProposalNet

    cfg = harness.load_json(CFG)
    pc = harness.program_config(cfg)
    w = weights_hrnet.seeded(cfg["model"], 2**31 + 7, "cpu")
    with torch.device("meta"):
        model = PoseProposalNet(pc.model, dtype=torch.float32)
    assert set(w) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert w[k].shape == v.shape, k
    assert len(refhrnet.conv_specs(cfg["model"])) == 327


def _run(program: str = "program"):
    cfg = _tiny_file()
    work = dict(harness.load_json(harness.BENCH
                                  / "workloads/hrw32-train-b128.json"))
    torch.manual_seed(0)
    run = tiny.run(work, TRAFFIC, seed=2**31 + 3, program=program, cfg=cfg)
    entry = train_hrnet.Entry(run)
    out = entry.window(0.0)
    entry.release()
    return harness.judge(entry.check(), work["limits"]), out


@pytest.fixture
def _threads(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    monkeypatch.setattr(harness, "program_config", tiny.program_config)
    yield
    torch.set_num_threads(n)


def test_the_entry_runs_and_a_state_left_unchanged_fails(_threads):
    checks, out = _run()
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["obs"]["flops_per_image"] == flops_hrnet.train_flops(
        _tiny_file()["model"])
    assert checks["change_gap_median"]["value"] < 0.5, checks
    with faults.planted("unchanged"):
        checks, _ = _run()
    assert checks["change_gap_median"]["value"] >= 0.99, checks
    assert not harness.passed(checks)


def test_span_readings_match_launches_to_device_records():
    """``yardstick/spans.py`` over a synthetic window: device time launched
    inside the exchange spans (a copy's too), and the kernel launches
    inside the calls that have a device record."""
    from perfbench.tests.test_perfbench_trace import CPU, CUDA, Ev
    from perfbench.yardstick import readers, spans
    from perfbench.yardstick.trace import CALL, TRACE_MARKERS, WINDOW, Trace

    ev = []
    for i in range(TRACE_MARKERS):              # markers before the window
        ev += [Ev("cudaLaunchKernel", CPU, i, 1, corr=100 + i),
               Ev("marker", CUDA, 50 + i, 1, corr=100 + i)]
    ev += [Ev(WINDOW, CPU, 1000, 10000, annotation=True),
          Ev(CALL, CPU, 1000, 9000, annotation=True),
          Ev(spans.FUSE, CPU, 2000, 1000, annotation=True),
          Ev(spans.FUSE, CPU, 5000, 500, annotation=True),
          Ev(spans.FUSE, CUDA, 2100, 900, annotation=True)]
    # (launch at, device start, duration): the last launch is after the call
    for j, (at, start, dur) in enumerate([(1500, 1600, 100),
                                          (2500, 2600, 300),
                                          (5200, 5300, 40),
                                          (7000, 7100, 200),
                                          (10500, 10600, 50)]):
        ev += [Ev("cudaLaunchKernel", CPU, at, 5, corr=10 + j),
               Ev(f"kernel{j}", CUDA, start, dur, corr=10 + j)]
    ev += [Ev("cudaMemcpyAsync", CPU, 2700, 5, corr=30),
           Ev("Memcpy DtoD", CUDA, 2950, 20, corr=30)]
    sp = spans.Spans(ev, (CALL, spans.FUSE))
    assert sp.count(spans.FUSE) == 2 and sp.count(CALL) == 1
    assert sp.device_s(spans.FUSE) == (300 + 40 + 20) / 1e9
    assert sp.launches(CALL) == 4
    obs = {"trace": Trace(ev), "spans": sp, "steps": 2}
    assert spans.span_ms(obs, spans.FUSE) == 1e3 * 360e-9 / 2
    assert spans.launches_per_step(obs) == 2.0
    assert spans.span_ms({**obs, "spans": None}, spans.FUSE) is None
    assert readers.idle_pct(obs) is not None
