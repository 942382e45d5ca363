"""The port's accuracy tools (tools/torch_{oracle_ceiling,threshold_sweep,
crowding_study,export_snapshot}.py) against the JAX package's
(tools/{oracle_ceiling,threshold_sweep,crowding_study,export_snapshot}.py)
on the CPU: each case runs the JAX tool's ``main`` and the port tool's
``main(["--device", "cpu", ...])`` on the same arguments at a small size.
The stage profilers (tools/torch_{train,bwd,fwd}_split.py and their sweep)
join the first test, that every tool raises without CUDA; their CPU
checks are in tests/test_torch_split_tools.py.

Tolerances:
  * oracle ceilings, collision bounds and lost-person fractions: equal.
    The maps are the GT's, encoded the same way on both sides, and the
    post-process decisions are bitwise (tests/test_torch_postprocess.py),
    so the printed four decimals and the crowding JSON are equal;
  * model PCKh: within 3e-3, about one joint in 378. Both sides compute
    the forward in bf16, and PyTorch rounds each op where XLA's CPU keeps
    some in f32 (tests/test_torch_model.py); the one crowding point where
    that rounding flips two joints is named, and in f32 the crowding
    study's JSON is equal, model PCKh included;
  * the sweep's evaluation on the JAX package's own logits: exact, as in
    tests/test_torch_snapshot.py::test_snapshot_oks_on_jax_logits_is_exact;
  * the sweep over a directory of the port's checkpoints: its maps
    bitwise the port's eval forward of the checkpoint's EMA (the same
    calls);
  * the exported snapshot: the JAX forward of the file within
    tests/test_torch_model.py's bf16 tolerance (3e-2 of the largest logit)
    of the port's eval forward of the checkpoint.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from tools import crowding_study as jax_crowding
from tools import oracle_ceiling as jax_oracle
from tools import threshold_sweep as jax_sweep
from tools import (torch_bwd_split, torch_crowding_study,
                   torch_export_snapshot, torch_fwd_split,
                   torch_oracle_ceiling, torch_split_sweep,
                   torch_threshold_sweep, torch_train_split)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPII = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
CROWD = os.path.join(ROOT, "artifacts", "crowd_hero_r5_ema_f16.npz")
MODEL_TOL = 3e-3
BF16_TOL = 3e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("tool, argv", [
    (torch_oracle_ceiling, ["--size", "1"]),
    (torch_threshold_sweep, ["--ckpt-dir", MPII, "--size", "1"]),
    (torch_crowding_study, ["--protocols", "1", "--size", "1"]),
    (torch_export_snapshot, ["--config", "tiny_test", "--ckpt-dir", "none",
                             "--out", "none.npz"]),
    (torch_train_split, ["--config", "tiny_test", "--batch", "1"]),
    (torch_bwd_split, ["--config", "tiny_test", "--batches", "1"]),
    (torch_fwd_split, ["--config", "tiny_test", "--batch", "1"]),
    (torch_split_sweep, ["--out", "none.jsonl"])])
def test_tools_run_on_cuda_and_raise_without_it(monkeypatch, tool, argv):
    """``--device`` defaults to cuda; without a GPU a tool raises before it
    does any work, with no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)


@pytest.mark.parametrize("persons", [1, 3])
def test_oracle_ceiling_matches_jax(capsys, persons):
    argv = ["--config", "mpii_r18_384", "--size", "8", "--num-persons",
            str(persons), "--per-joint"]
    want = _printed(capsys, jax_oracle.main, argv)
    got = _printed(capsys, torch_oracle_ceiling.main,
                   argv + ["--device", "cpu"])
    assert "PCKh@0.5 mean" in want
    assert got == want


def _crowding(tmp_path, main, name, argv):
    out = str(tmp_path / name)
    main(argv + ["--out", out])
    with open(out) as f:
        return json.load(f)


def test_crowding_study_oracle_matches_jax(tmp_path, capsys):
    argv = ["--config", "coco_r18_384", "--protocols", "1,4,0", "--size",
            "4", "--nms-grid", "0.3,0.6"]
    want = _crowding(tmp_path, jax_crowding.main, "jax.json", argv)
    got = _crowding(tmp_path, torch_crowding_study.main, "port.json",
                    argv + ["--device", "cpu"])
    assert [r["protocol"] for r in want["results"]] == [
        "1_person", "4_person", "random_1_to_12"]
    assert got == want


CROWD_ARGV = ["--config", "coco_r18_384", "--snapshot", CROWD, "--protocols",
              "3,0", "--size", "4", "--nms-grid", "0.3,0.6"]


def test_crowding_study_model_pckh_matches_jax_in_f32(tmp_path, capsys,
                                                      monkeypatch):
    """The crowd snapshot computing in f32 on both sides (each package's
    ``get_config`` patched to give the config with ``train.dtype``
    float32): the whole JSON, model PCKh included, is equal."""
    import ppn_tpu.configs
    import ppn_tpu_torch.configs

    for configs in (ppn_tpu.configs, ppn_tpu_torch.configs):
        def get_f32(name, _get=configs.get_config):
            cfg = _get(name)
            return dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, dtype="float32"))

        monkeypatch.setattr(configs, "get_config", get_f32)
    want = _crowding(tmp_path, jax_crowding.main, "jax.json", CROWD_ARGV)
    got = _crowding(tmp_path, torch_crowding_study.main, "port.json",
                    CROWD_ARGV + ["--device", "cpu"])
    assert all("model_pckh" in p for r in want["results"]
               for p in r["points"])
    assert got == want


def test_crowding_study_model_pckh_matches_jax(tmp_path, capsys):
    """The tools as shipped, in bf16: every key but the model's numbers is
    equal, and each point's model PCKh is within 3e-3 (~one joint in
    378) except where bf16 rounding reorders detections (ROADMAP queue
    3: on random_1_to_12 at nms 0.6 two of 437 joints flip, 4.6e-3, and in
    f32 the two tools agree exactly, above). The evaluation itself is
    exact on the JAX package's logits, which are within the bf16 logit
    tolerance of the port's."""
    from ppn_tpu.configs import get_config as jax_get_config
    from ppn_tpu.data.synthetic import SyntheticPoseDataset
    from ppn_tpu.train import steps as jst
    from ppn_tpu.utils.params_io import load_inference_npz as jax_load
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.utils.params_io import load_inference_npz

    want = _crowding(tmp_path, jax_crowding.main, "jax.json", CROWD_ARGV)
    got = _crowding(tmp_path, torch_crowding_study.main, "port.json",
                    CROWD_ARGV + ["--device", "cpu"])
    model_keys = ("model_pckh", "model_over_ceiling")
    misses = []
    for g, w in zip(got["results"], want["results"]):
        assert g.keys() == w.keys()
        for k in ("protocol", "images", "collision_bound",
                  "lost_person_frac", "ceiling_over_bound"):
            assert g[k] == w[k], k
        for gp, wp in zip(g["points"], w["points"]):
            assert gp.keys() == wp.keys()
            assert ({k: v for k, v in gp.items() if k not in model_keys}
                    == {k: v for k, v in wp.items() if k not in model_keys})
            if abs(gp["model_pckh"] - wp["model_pckh"]) > MODEL_TOL:
                misses.append((g["protocol"], gp["nms"], gp["model_pckh"],
                               wp["model_pckh"]))
    assert misses == [("random_1_to_12", 0.6, 0.6568, 0.6522)]

    jcfg, cfg = jax_get_config("coco_r18_384"), get_config("coco_r18_384")
    graphdef, state = jax_load(jcfg, CROWD)
    model = load_inference_npz(cfg, CROWD, device="cpu")
    ds = SyntheticPoseDataset(jcfg, size=4, seed=10_000, num_persons=None)
    images = np.stack([ds[i]["image"] for i in range(4)])
    jfm = np.array(jst.make_forward(jcfg, graphdef)(state, images))
    with torch.no_grad():
        tfm = model(torch.from_numpy(images)).numpy()
    assert np.abs(tfm - jfm).max() <= BF16_TOL * np.abs(jfm).max()
    samples = [ds[i] for i in range(4)]
    for nms in (0.3, 0.6):
        m = dataclasses.replace(cfg.model, detection_thresh=0.02,
                                nms_thresh=nms)
        jm = dataclasses.replace(jcfg.model, detection_thresh=0.02,
                                 nms_thresh=nms)
        assert torch_oracle_ceiling.pckh_of_maps(
            m, torch.from_numpy(jfm), samples, "cpu")["pckh/mean"] == (
            jax_crowding.eval_fms(jm, jfm, ds, 4, 8))


SWEEP_ARGV = ["--config", "mpii_r18_384", "--ckpt-dir", MPII, "--size", "8",
              "--det", "0.10,0.20", "--nms", "0.30,0.45"]


def _sweep_points(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_threshold_sweep_matches_jax(capsys):
    want = _printed(capsys, jax_sweep.main, SWEEP_ARGV)
    got = _printed(capsys, torch_threshold_sweep.main,
                   SWEEP_ARGV + ["--device", "cpu"])
    assert got.splitlines()[0] == want.splitlines()[0] == (
        f"loaded inference snapshot {MPII}")
    w, g = _sweep_points(want), _sweep_points(got)
    assert len(w) == len(g) == 4
    for gp, wp in zip(g, w):
        assert (gp["det"], gp["nms"]) == (wp["det"], wp["nms"])
        assert abs(gp["pckh_mean"] - wp["pckh_mean"]) <= MODEL_TOL, (gp, wp)
    assert re.search(r"^best: \{", got, re.M)


def test_threshold_sweep_points_on_jax_logits_are_exact():
    """The JAX package's own feature maps of the MPII snapshot through the
    port's per-point evaluation (``sweep_point``): every point's PCKh
    summary equals the JAX tool's evaluation of the same maps, to the bit."""
    from ppn_tpu.apps.predict import load_state
    from ppn_tpu.configs import get_config as jax_get_config
    from ppn_tpu.data.pipeline import epoch_batches
    from ppn_tpu.data.synthetic import SyntheticPoseDataset
    from ppn_tpu.eval.pckh import PCKhEvaluator
    from ppn_tpu.eval.runner import add_pckh_batch, pad_batch
    from ppn_tpu.ops import postprocess as jpost
    from ppn_tpu.train import steps as jst
    from ppn_tpu_torch.configs import get_config

    jbase, base = jax_get_config("mpii_r18_384"), get_config("mpii_r18_384")
    val = SyntheticPoseDataset(jbase, size=8, seed=10_000, cache=True,
                               num_persons=2)
    graphdef, state = load_state(jbase, MPII)
    forward = jst.make_forward(jbase, graphdef)
    batch, n_real = pad_batch(next(epoch_batches(
        val, 8, rng=np.random.default_rng(0), shuffle=False,
        drop_remainder=False)), 8)
    fm = np.asarray(forward(state, batch["image"]))
    for det, nms in ((0.10, 0.30), (0.20, 0.45)):
        jcfg = dataclasses.replace(jbase, model=dataclasses.replace(
            jbase.model, detection_thresh=det, nms_thresh=nms))
        ev = PCKhEvaluator(jcfg.model)
        add_pckh_batch(ev, jax.device_get(jpost.postprocess_batch_fast(
            jcfg.model, fm)), batch, n_real)
        got = torch_threshold_sweep.sweep_point(
            base, torch.from_numpy(fm), batch, det, nms)
        assert got == ev.summarize()


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A port checkpoint directory: tiny_test trained two steps on the CPU
    with an EMA (decay 0.9) tracked."""
    from ppn_tpu_torch.apps import train

    ckpt = str(tmp_path_factory.mktemp("tiny") / "ckpt")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--device", "cpu", "--config", "tiny_test", "--overfit",
                    "2", "--steps", "2", "--ema-decay", "0.9",
                    "--ckpt-dir", ckpt])
    finally:
        torch.set_num_threads(n)
    return ckpt


def _ema_state(ckpt):
    """The checkpoint restored with its EMA, on the CPU."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.train.checkpoint import load_state

    cfg = get_config("tiny_test")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.999))
    return cfg, load_state(cfg, ckpt, device="cpu")


def test_threshold_sweep_reads_a_port_checkpoint_directory(tiny_ckpt,
                                                           capsys):
    """``--ckpt-dir`` a directory of ``ckpt_*.pt``: the sweep's maps are
    the eval forward of the checkpoint's EMA parameters, and it prints one
    point per (det, nms) and the best."""
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.train import steps as st

    got = _printed(capsys, torch_threshold_sweep.main, [
        "--device", "cpu", "--config", "tiny_test", "--ckpt-dir", tiny_ckpt,
        "--size", "4", "--det", "0.1,0.2", "--nms", "0.45"])
    assert len(_sweep_points(got)) == 2 and "best: {" in got
    assert "loaded inference snapshot" not in got
    cfg, state = _ema_state(tiny_ckpt)
    assert state.ema is not None
    val = SyntheticPoseDataset(cfg, size=4, seed=10_000, cache=True,
                               num_persons=2)
    fms, gt = torch_threshold_sweep.forward_once(
        cfg, st.eval_model(state), val, 8, False, "cpu")
    images = torch.from_numpy(gt["image"])
    assert torch.equal(fms, st.make_forward(state)(images))


def test_export_snapshot_loads_in_jax(tiny_ckpt, tmp_path, capsys):
    """The port checkpoint exported by the port tool; the JAX package
    loads the file, and its eval forward is the port's eval forward of the
    checkpoint within the bf16 tolerance."""
    from ppn_tpu.configs import get_config as jax_get_config
    from ppn_tpu.train import steps as jst
    from ppn_tpu.utils.params_io import load_inference_npz as jax_load
    from ppn_tpu_torch.train import steps as st

    out = str(tmp_path / "snap.npz")
    torch_export_snapshot.main(["--device", "cpu", "--config", "tiny_test",
                                "--ckpt-dir", tiny_ckpt, "--ema", "--out",
                                out])
    printed = capsys.readouterr().out
    assert printed.startswith("step 2: wrote 107 leaves (EMA params) -> ")

    cfg, state = _ema_state(tiny_ckpt)
    jcfg = jax_get_config("tiny_test")
    graphdef, jstate = jax_load(jcfg, out)
    images = np.random.default_rng(3).integers(
        0, 256, (2, *cfg.model.insize, 3), dtype=np.uint8)
    want = np.asarray(jst.make_forward(jcfg, graphdef)(jstate, images))
    got = st.make_forward(state)(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
