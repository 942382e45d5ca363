"""The port's config.ini importer (``ppn_tpu_torch/ini_compat.py``) and
``configs.resolve_config`` against ``ppn_tpu/configs/ini_compat.py`` and
``ppn_tpu/configs/__init__.py``: the cases of ``tests/test_ini_compat.py``
must give equal configs and the same printed report. Then each of the
port's five CLIs must use the INI's values, resolved as the JAX CLI
resolves them."""

import dataclasses
import textwrap

import pytest

from ppn_tpu.configs import resolve_config as jax_resolve_config
from ppn_tpu.configs.ini_compat import load_ini as jax_load_ini
from ppn_tpu.configs.overrides import apply_overrides as jax_apply_overrides
from ppn_tpu_torch.configs import get_config, resolve_config
from ppn_tpu_torch.ini_compat import load_ini
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REFERENCE_INI = textwrap.dedent("""
    [model]
    insize = 320,320
    outsize = 10
    local_grid_size = 7,7
    parts_scale = 0.25
    lambda_coor = 4.0
    detection_thresh = 0.2
    thresh = 0.35
    min_num_keypoints = 3

    [training]
    batchsize = 16
    learning_rate = 0.01
    momentum = 0.95
    seed = 7

    [dataset]
    train_root = /data/mpii
    rotate = 30
    some_unknown_key = whatever
""")


def _same(ours, theirs):
    assert ours.name == theirs.name
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _both(capsys, fn, jax_fn, *args, **kwargs):
    """(port config, JAX config), asserting both print the same report."""
    ours = fn(*args, **kwargs)
    printed = capsys.readouterr().out
    theirs = jax_fn(*args, **kwargs)
    assert printed == capsys.readouterr().out
    _same(ours, theirs)
    return ours, printed


@pytest.fixture
def ini_path(tmp_path):
    p = tmp_path / "config.ini"
    p.write_text(REFERENCE_INI)
    return str(p)


def test_load_ini_matches_jax(ini_path, capsys):
    cfg, printed = _both(capsys, load_ini, jax_load_ini, ini_path)
    m, t, d = cfg.model, cfg.train, cfg.data
    assert (m.insize, m.outsize, m.local_grid_size) == ((320, 320), (10, 10),
                                                        (7, 7))
    assert (m.parts_scale, m.lambda_coor, m.detection_thresh, m.nms_thresh,
            m.min_num_keypoints) == (0.25, 4.0, 0.2, 0.35, 3)
    assert (t.batch_size, t.learning_rate, t.momentum, t.seed) == (16, 0.01,
                                                                  0.95, 7)
    assert (d.root, d.rotate_deg) == ("/data/mpii", 30.0)
    assert cfg.train.weight_decay == 5e-4
    assert printed == ("ini_compat: ignored unknown keys: "
                       "['dataset.some_unknown_key']\n")


def test_load_ini_coco_base_matches_jax(ini_path, capsys):
    cfg, _ = _both(capsys, load_ini, jax_load_ini, ini_path,
                   base="coco_r18_384")
    assert cfg.model.num_keypoints == 17
    assert cfg.model.insize == (320, 320)


def test_strict_mode_raises_like_jax(tmp_path, capsys):
    ini = tmp_path / "bad.ini"
    ini.write_text("[model]\ninsize = 384\ndetection_tresh = 0.2\n")
    with pytest.raises(KeyError, match="detection_tresh") as ours:
        load_ini(str(ini), strict=True)
    with pytest.raises(KeyError) as theirs:
        jax_load_ini(str(ini), strict=True)
    assert str(ours.value) == str(theirs.value)
    cfg, _ = _both(capsys, load_ini, jax_load_ini, str(ini))
    assert cfg.model.insize == (384, 384)


def test_insize_only_derives_matching_grid_like_jax(tmp_path, capsys):
    p = tmp_path / "c.ini"
    p.write_text("[model_param]\ninsize = 224x224\n")
    cfg, _ = _both(capsys, load_ini, jax_load_ini, str(p), base="tiny_test")
    assert cfg.model.outsize == (7, 7)
    assert all(isinstance(v, int) for v in cfg.model.outsize)
    p.write_text("[model_param]\ninsize = 100x100\n")
    with pytest.raises(ValueError) as ours:
        load_ini(str(p), base="tiny_test")
    with pytest.raises(ValueError) as theirs:
        jax_load_ini(str(p), base="tiny_test")
    assert str(ours.value) == str(theirs.value)


def test_resolve_config_matches_jax(tmp_path, capsys):
    assert resolve_config("tiny_test") == get_config("tiny_test")
    _same(resolve_config("tiny_test"), jax_resolve_config("tiny_test"))
    p = tmp_path / "c.ini"
    p.write_text("[train]\nlearning_rate = 0.125\nhflip_prob = 0.25\n")
    cfg, _ = _both(capsys, resolve_config, jax_resolve_config, "tiny_test",
                   str(p))
    assert (cfg.train.learning_rate, cfg.data.hflip_prob) == (0.125, 0.25)


# ---- --ini in every CLI -----------------------------------------------------

class _Resolved(Exception):
    """Raised where a CLI hands its config on: the test has what it needs."""


# CLI → (argv after --config/--ini, the JAX CLI's overrides after the INI)
CLIS = {
    "train": (["--lr", "0.03", "--set", "model.nms_thresh=0.4"],
              ["train.learning_rate=0.03", "model.nms_thresh=0.4"]),
    "predict": (["--synthetic", "0", "--set", "model.nms_thresh=0.4"],
                ["model.nms_thresh=0.4"]),
    "serve": (["--selftest", "2"], []),
    "video": (["--frames", "2", "--set", "model.nms_thresh=0.4"],
              ["model.nms_thresh=0.4"]),
    "evaluate": (["--nms-thresh", "0.5", "--set", "model.nms_thresh=0.4"],
                 ["model.nms_thresh=0.5", "model.nms_thresh=0.4"]),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_uses_the_ini(cli, tmp_path, monkeypatch, capsys):
    """The config each CLI goes on with: the INI's detection_thresh and
    seed over ``--config``, then its flags and ``--set`` last, equal to the
    JAX package's resolution of the same INI and flags."""
    import importlib

    from ppn_tpu_torch.inference import Predictor

    ini = tmp_path / "config.ini"
    ini.write_text("[model]\ndetection_thresh = 0.123\nthresh = 0.3\n"
                   "[training]\nseed = 5\n")
    seen = []

    def stop(cfg, *args, **kwargs):
        seen.append(cfg)
        raise _Resolved

    # train hands its config to make_datasets, the others to the Predictor
    monkeypatch.setattr(importlib.import_module("ppn_tpu_torch.apps.train"),
                        "make_datasets", stop)
    monkeypatch.setattr(Predictor, "from_checkpoint", classmethod(
        lambda cls, cfg, *a, **k: stop(cfg)))
    flags, jax_overrides = CLIS[cli]
    main = importlib.import_module(f"ppn_tpu_torch.apps.{cli}").main
    with pytest.raises(_Resolved):
        main(["--device", "cpu", "--config", "tiny_test", "--ini", str(ini),
              *flags])
    want = jax_apply_overrides(jax_load_ini(str(ini), base="tiny_test"),
                               jax_overrides)
    (cfg,) = seen
    _same(cfg, want)
    assert cfg.model.detection_thresh == 0.123 and cfg.train.seed == 5
    assert cfg.model.nms_thresh == (0.3 if cli == "serve" else 0.4)
    assert get_config("tiny_test").model.detection_thresh != 0.123
    assert capsys.readouterr().out == ""
