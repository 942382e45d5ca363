"""Each cell's correctness check catches the faults its timed path can
have, and its control, at tiny_test on the CPU: the harness's look for a
card is skipped, the rest of a run is driven with the timed path broken
underneath, and ``correct`` comes out false. The sound program passes."""

import numpy as np
import pytest
import torch

from perfbench import faults, harness
from perfbench.entries import predict, train
from perfbench.tests import tiny

TRAFFIC = {
    "predict": {"batch": 8, "distinct": 4, "warmup_calls": 1},
    "train": {"batch": 4, "steps_per_call": 4, "rows": 16, "renders": 8},
}
CELLS = {"predict": "r18-infer-b128", "train": "r18-train-b128"}
ENTRIES = {"predict": predict.Entry, "train": train.Entry}


def _correct(kind: str, program: str = "program", seconds: float = 0.3,
             cell: str = None, backbone: str = "resnet18"):
    work = dict(harness.load_json(
        harness.BENCH / "workloads" / f"{cell or CELLS[kind]}.json"))
    work.update(entry=kind, weights={"kind": "seeded"})
    torch.manual_seed(0)
    run = tiny.run(work, TRAFFIC[kind], seed=2**31 + 3, program=program,
                   cfg=tiny.config_file("tiny_test", backbone))
    entry = ENTRIES[kind](run)
    out = entry.window(seconds)
    entry.release()
    checks = harness.judge(entry.check(), work["limits"])
    return harness.passed(checks) and out["failed"] == 0, checks


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["predict", "train"])
def test_the_sound_program_passes(kind):
    ok, checks = _correct(kind)
    assert ok, checks


@pytest.mark.parametrize("kind", ["predict", "train"])
def test_the_control_fails(kind):
    ok, checks = _correct(kind, program="fp8")
    assert not ok, checks


@pytest.mark.parametrize("witness", ["nudge", "image16"])
def test_the_reference_against_itself_passes(witness):
    # the float32 reference in the program's place, its augmented image one
    # ulp up or in the configuration's bfloat16: the least that a sound
    # program can differ by, which no limit may refuse
    ok, checks = _correct("train", program=witness)
    assert ok, checks


@pytest.mark.parametrize("fault", ["half_images", "altered"])
def test_inference_faults_fail(fault):
    with faults.planted(fault):
        ok, checks = _correct("predict")
    assert not ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "later_unchanged",
                                   "half_batch"])
@pytest.mark.parametrize("cell,backbone", [("r18-train-b128", "resnet18"),
                                           ("r50-train-b64", "resnet50")])
def test_training_faults_fail(monkeypatch, fault, cell, backbone):
    # ResNet-50's cell at 64x64: its sound readings are noise there (the
    # last stage's BatchNorm takes statistics over 16 values), so only the
    # faults, which read 0.76 and more, are held at this size
    monkeypatch.setattr(harness, "program_config", tiny.program_config)
    with faults.planted(fault):
        ok, checks = _correct("train", cell=cell, backbone=backbone)
    assert not ok, checks


def test_a_fault_after_the_first_call_fails_only_the_window_call():
    with faults.planted("later_unchanged"):
        ok, checks = _correct("train")
    assert not ok, checks
    bad = {k for k, c in checks.items() if not c["value"] <= c["limit"]}
    assert bad and all(k.startswith("window_") for k in bad), checks


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "r18-infer-b128",
         "--seed", "12345", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert np.isfinite(line["metrics"]["infer_img_per_s"]["value"])
