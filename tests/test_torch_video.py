"""The port's streaming video path (ppn_tpu_torch/apps/video.py) against
``ppn_tpu/apps/video.py`` on the CPU: the frame pipeline (upload, /255,
resize, model, post-process) on the same frame and weights gives the same
decisions; the synthetic source gives the same frames; the CLI runs.

Weights: tests/test_torch_model.py's seeded weights in f32 (seed 5, whose
maps keep proposals at detection threshold 0.02), loaded into both
packages. The resizes differ by ≤ 2.4e-7 and the f32 forwards by ~1e-6 of
the largest logit, which moves no decision on these frames.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from ppn_tpu.apps import video as jvideo
from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.nn.model import PoseProposalNet as JaxPPN
from ppn_tpu.train import steps as jst
from ppn_tpu_torch.apps import video
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.inference import fetch_async, wait_host
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.utils.params_io import state_dict_from_jax_leaves

from test_torch_model import _jax_template, _numpy_leaves
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_get_config("tiny_test"), get_config("tiny_test")
    jcfg, cfg = (dataclasses.replace(
        c, train=dataclasses.replace(c.train, dtype="float32",
                                     ema_decay=0.0),
        model=dataclasses.replace(c.model, detection_thresh=0.02))
        for c in (jcfg, cfg))
    _, flat, treedef = _jax_template(jcfg.model, jnp.float32)
    leaves = _numpy_leaves(flat, seed=5)
    tree = jax.tree.unflatten(treedef, leaves)
    graphdef = nnx.split(nnx.eval_shape(
        lambda: JaxPPN(jcfg.model, dtype=jnp.float32, rngs=nnx.Rngs(0))),
        nnx.Param, ...)[0]
    jstate = jst.TrainState(params=tree["params"], rest=tree["rest"],
                            opt_state=None, step=0,
                            rng=jax.random.PRNGKey(0))
    state = st.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax_leaves(cfg, leaves, state.model))
    return jcfg, cfg, graphdef, jstate, state


@pytest.mark.parametrize("shape, pre_resized", [((120, 160), False),
                                                ((64, 64), True)])
def test_pipeline_matches_jax(models, shape, pre_resized):
    jcfg, cfg, graphdef, jstate, state = models
    frame = next(jvideo.synthetic_frames(1, size=shape, fps=0))
    want = jax.device_get(jvideo.make_video_pipeline(
        jcfg, graphdef, pre_resized=pre_resized)(jstate, frame))
    pipe = video.make_video_pipeline(cfg, state, pre_resized=pre_resized)
    got = wait_host(*fetch_async(pipe(frame)))
    assert got.valid.shape == (cfg.model.max_instances,)
    assert got.kp_score.any()
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.kp_score, want.kp_score, rtol=1e-4,
                               atol=1e-5)


def test_synthetic_frames_match_jax():
    """The same pre-rendered, cycled pool as the JAX package's source."""
    got = list(video.synthetic_frames(5, size=(64, 64), pool=2, fps=0))
    want = list(jvideo.synthetic_frames(5, size=(64, 64), pool=2, fps=0))
    assert len(got) == 5 and got[0].dtype == np.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], got[2])      # the pool cycles
    assert not np.array_equal(got[0], got[1])          # and is diverse


def test_host_resize():
    frame = np.random.default_rng(0).integers(0, 255, (72, 96, 3), np.uint8)
    small = video.host_resize(frame, (64, 64))
    assert small.shape == (64, 64, 3) and small.dtype == np.uint8
    np.testing.assert_array_equal(small, jvideo.host_resize(frame, (64, 64)))
    assert video.host_resize(small, (64, 64)) is small


def test_capture_frames_from_file(tmp_path):
    """tests/test_video_file.py:9 on the port: a 5-frame mp4 written
    through cv2 comes back as 5 RGB frames, the same as the reference's
    ``capture_frames`` gives, correlated with what was written (the codec
    is lossy)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (160, 120))
    assert w.isOpened(), "no mp4 encoder in this OpenCV"
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
              for _ in range(5)]
    for f in frames:
        w.write(f[..., ::-1])  # the writer takes BGR
    w.release()
    got = list(video.capture_frames(path))
    want = list(jvideo.capture_frames(path))
    assert len(got) == len(want) == 5
    assert got[0].shape == (120, 160, 3)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    corr = np.corrcoef(got[2].ravel().astype(float),
                       frames[2].ravel().astype(float))[0, 1]
    assert corr > 0.5, corr


def test_capture_frames_bad_source():
    pytest.importorskip("cv2")
    with pytest.raises(RuntimeError, match="cannot open"):
        next(video.capture_frames("/nonexistent/clip.mp4"))


def test_main_on_synthetic_frames(tmp_path, capsys):
    """The CLI on the CPU: the pipelined loop, then --no-overlap with the
    host pre-resize and annotated frames."""
    base = ["--config", "tiny_test", "--source", "synthetic", "--frames",
            "4", "--device", "cpu", "--set", "model.detection_thresh=0.02"]
    summary = video.main(base + ["--json"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == summary
    assert 1 <= summary["frames"] <= 4 and summary["p50_ms"] > 0
    out = tmp_path / "frames"
    summary = video.main(base + ["--no-overlap", "--pre-resize",
                                 "--out", str(out)])
    assert summary["frames"] >= 1
    assert (out / "frame_0000.png").exists()


def test_main_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A directory source is ported (the native decode pool): one without
    JPEGs is refused as the JAX package refuses it, one with JPEGs
    streams."""
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    with pytest.raises(RuntimeError, match="no .jpg files"):
        video.main(["--config", "tiny_test", "--source", str(frames),
                    "--device", "cpu"])
    rng = np.random.default_rng(1)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (48, 80, 3), np.uint8)).save(
            frames / f"{i}.jpg")
    summary = video.main(["--config", "tiny_test", "--source", str(frames),
                          "--frames", "3", "--device", "cpu"])
    assert 1 <= summary["frames"] <= 3
    # --ini is ported: the stream runs on the INI's threshold
    from test_torch_predict_cli import configs_loaded

    ini = tmp_path / "x.ini"
    ini.write_text("[model]\ndetection_thresh = 0.02\n")
    seen = configs_loaded(monkeypatch)
    summary = video.main(["--config", "tiny_test", "--ini", str(ini),
                          "--frames", "2", "--device", "cpu"])
    assert summary["frames"] >= 1
    assert [c.model.detection_thresh for c in seen] == [0.02]
