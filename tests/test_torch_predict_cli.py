"""The port's predict and serve CLIs, its JSON and picture output and
``Predictor.from_checkpoint``, on the CPU; the output against
``ppn_tpu/apps/predict.py`` and ``ppn_tpu/utils/draw.py`` on the same
People."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ppn_tpu.apps import predict as jpredict
from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.utils.draw import draw_people as jax_draw_people
from ppn_tpu_torch.apps import predict, serve
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.ops import encode as enc
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.checkpoint import Checkpointer, load_state
from ppn_tpu_torch.utils.draw import draw_people
from ppn_tpu_torch.utils.params_io import save_inference_npz
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def scene():
    """mpii_r18_384: one synthetic image and the People parsed from its
    oracle map (the ground truth encoded as a feature map)."""
    cfg = get_config("mpii_r18_384")
    s = SyntheticPoseDataset(cfg, size=1, seed=3, num_persons=2)[0]
    t = enc.encode_batch(cfg.model, *(torch.from_numpy(np.asarray(s[k]))[None]
                                      for k in ("keypoints", "visible",
                                                "bboxes", "valid")))
    ppl = postprocess_batch_plain(cfg.model,
                                  enc.targets_to_feature_map(cfg.model, t))
    return cfg, s["image"], People(*(f[0].numpy() for f in ppl))


def test_people_to_json_matches_jax(scene):
    cfg, _, people = scene
    got = predict.people_to_json(cfg, people)
    assert len(got) == 2 and all(p["keypoints"] for p in got)
    assert got == jpredict.people_to_json(jax_get_config(cfg.name), people)
    json.dumps(got)


def test_draw_people_matches_jax(scene):
    cfg, image, people = scene
    got = np.asarray(draw_people(cfg.model, image, people))
    assert got.shape == (*cfg.model.insize, 3)
    canvas = np.zeros_like(image)
    assert np.asarray(draw_people(cfg.model, canvas, people)).max() > 0
    np.testing.assert_array_equal(
        got, np.asarray(jax_draw_people(jax_get_config(cfg.name).model,
                                        image, people)))


def test_predict_main(tmp_path, capsys):
    out = tmp_path / "pose.png"
    argv = ["--config", "tiny_test", "--synthetic", "1", "--device", "cpu",
            "--set", "model.detection_thresh=0.02"]
    people = predict.main(argv + ["--flip-tta", "--out", str(out)])
    printed = capsys.readouterr().out
    assert out.exists() and f"wrote {out}" in printed
    cfg = dataclasses.replace(get_config("tiny_test"), model=dataclasses.replace(
        get_config("tiny_test").model, detection_thresh=0.02))
    image = SyntheticPoseDataset(cfg, size=2, seed=11)[1]["image"]
    want = Predictor.from_checkpoint(cfg, None, flip_tta=True,
                                     device="cpu").predict_single(image)
    for a, b in zip(people, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):          # exactly one image source
        predict.main(["--config", "tiny_test", "--device", "cpu"])
    # the threshold from a config.ini in place of --set: the same People
    ini = tmp_path / "x.ini"
    ini.write_text("[model]\ndetection_thresh = 0.02\n")
    from_ini = predict.main(argv[:-2] + ["--flip-tta", "--ini", str(ini)])
    for a, b in zip(from_ini, want):
        np.testing.assert_array_equal(a, b)


def configs_loaded(monkeypatch) -> list:
    """The configs ``Predictor.from_checkpoint`` is called with, from now."""
    seen = []
    load = Predictor.from_checkpoint.__func__

    def record(cls, cfg, *args, **kwargs):
        seen.append(cfg)
        return load(cls, cfg, *args, **kwargs)

    monkeypatch.setattr(Predictor, "from_checkpoint", classmethod(record))
    return seen


def test_serve_selftest(tmp_path, monkeypatch):
    assert serve.main(["--config", "tiny_test", "--selftest", "8",
                       "--threads", "3", "--max-batch", "4", "--window-ms",
                       "5", "--device", "cpu", "--json"]) == 0
    # --ini: the server runs on the INI's thresholds
    ini = tmp_path / "x.ini"
    ini.write_text("[model]\ndetection_thresh = 0.02\nthresh = 0.5\n")
    seen = configs_loaded(monkeypatch)
    assert serve.main(["--config", "tiny_test", "--ini", str(ini),
                       "--selftest", "2", "--threads", "2", "--max-batch",
                       "2", "--device", "cpu", "--json"]) == 0
    assert [(c.model.detection_thresh, c.model.nms_thresh)
            for c in seen] == [(0.02, 0.5)]


def test_from_checkpoint_sources(tmp_path):
    """A port checkpoint directory (the EMA as eval parameters), a snapshot
    (read as ``from_npz`` reads it; ``load_state`` refuses it), a directory
    of JAX Orbax checkpoints (refused with a ValueError), and directories
    without a checkpoint."""
    cfg = get_config("tiny_test")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9))
    state = st.create_train_state(cfg, device="cpu")
    with torch.no_grad():
        for p in state.ema.values():
            p.mul_(0.5)
    Checkpointer(str(tmp_path / "run")).save(3, state)
    pred = Predictor.from_checkpoint(cfg, str(tmp_path / "run"),
                                     device="cpu")
    for n, p in pred.model.named_parameters():
        assert torch.equal(p, state.ema[n])
    images = np.zeros((1, *cfg.model.insize, 3), np.uint8)
    want = Predictor(cfg, st.eval_model(state), device="cpu").predict(images)
    for a, b in zip(pred.predict(images), want):
        np.testing.assert_array_equal(a, b)

    snap = str(tmp_path / "snap.npz")
    save_inference_npz(snap, state)
    from_npz = Predictor.from_npz(cfg, snap, device="cpu").model
    got = Predictor.from_checkpoint(cfg, snap, device="cpu").model
    assert all(torch.equal(a, b) for a, b in
               zip(got.state_dict().values(), from_npz.state_dict().values()))
    with pytest.raises(ValueError, match="inference snapshot"):
        load_state(cfg, snap, device="cpu")

    os.makedirs(tmp_path / "orbax" / "100")
    with pytest.raises(ValueError, match="Orbax"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "orbax"), device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(cfg, str(tmp_path / "empty"), device="cpu")
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(cfg, str(tmp_path / "missing"),
                                  device="cpu")
