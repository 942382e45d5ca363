"""The port's own copies of the JAX package's host modules — configs,
config overrides, synthetic data, batching, PCKh, metric logging — must
agree with the originals exactly."""

import dataclasses
import json

import numpy as np
import pytest

from ppn_tpu.configs import base as jax_configs
from ppn_tpu.configs import overrides as jax_overrides
from ppn_tpu.data import pipeline as jax_pipeline
from ppn_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from ppn_tpu.eval import pckh as jax_pckh
from ppn_tpu.eval import runner as jax_runner
from ppn_tpu.ops.parse import People as JaxPeople
from ppn_tpu.utils import logging as jax_logging
from ppn_tpu_torch import configs, overrides
from ppn_tpu_torch.data import pipeline
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset, heldout_dataset
from ppn_tpu_torch.eval import pckh, runner
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.utils import logging

NAMES = sorted(jax_configs._REGISTRY)


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax(name):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    assert cfg.name == jcfg.name
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    for prop in ("num_keypoints", "num_classes", "num_limbs", "stride",
                 "num_box_channels", "num_limb_channels", "num_channels"):
        assert getattr(cfg.model, prop) == getattr(jcfg.model, prop), prop
    for f in dataclasses.fields(cfg.train):
        assert getattr(cfg.train, f.name) == getattr(jcfg.train, f.name)
    for f in dataclasses.fields(cfg.data):
        assert getattr(cfg.data, f.name) == getattr(jcfg.data, f.name)


def test_config_checks():
    assert set(configs._REGISTRY) == set(jax_configs._REGISTRY)
    with pytest.raises(KeyError):
        configs.get_config("nope")
    with pytest.raises(ValueError, match="odd"):
        configs.PPNConfig(local_grid_size=(4, 9))
    with pytest.raises(ValueError, match="topologically"):
        configs.PPNConfig(edges=((3, 2), (0, 3)))
    with pytest.raises(ValueError, match="instance"):
        configs.PPNConfig(keypoint_names=("head",) * 17)


@pytest.mark.parametrize("name,num_persons", [
    ("tiny_test", None), ("mpii_r18_384", 2), ("coco_r18_384", (3, 8))])
@pytest.mark.parametrize("cache", [False, True])
def test_synthetic_matches_jax(name, num_persons, cache):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    ours = SyntheticPoseDataset(cfg, size=8, seed=3, num_persons=num_persons,
                                cache=cache)
    theirs = JaxSynthetic(jcfg, size=8, seed=3, num_persons=num_persons,
                          cache=cache)
    for idx in (0, 5, 13):
        a, b = ours[idx], theirs[idx]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batches_match_jax():
    cfg, jcfg = configs.get_config("tiny_test"), jax_configs.get_config(
        "tiny_test")
    ours = pipeline.epoch_batches(
        SyntheticPoseDataset(cfg, size=5, seed=1), 2,
        rng=np.random.default_rng(0), drop_remainder=False, image_uint8=True)
    theirs = jax_pipeline.epoch_batches(
        JaxSynthetic(jcfg, size=5, seed=1), 2,
        rng=np.random.default_rng(0), drop_remainder=False, image_uint8=True)
    n = 0
    for a, b in zip(ours, theirs):
        pa, na = runner.pad_batch(a, 2)
        pb, nb = jax_runner.pad_batch(b, 2)
        assert na == nb
        for k in b:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        n += 1
    assert n == 3


def test_heldout_dataset_is_the_pinned_protocol():
    cfg = configs.get_config("mpii_r18_384")
    ds = heldout_dataset(cfg, num_persons=2)
    assert (len(ds), ds.seed) == (128, 10_000)
    img = ds[0]["image"]
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(
        img, JaxSynthetic(jax_configs.get_config("mpii_r18_384"), size=128,
                          seed=10_000, cache=True, num_persons=2)[0]["image"])


def test_pckh_matches_jax():
    """Both evaluators on the same predictions and GT give the same
    summary; predictions are GT keypoints with noise, some persons
    dropped."""
    cfg = configs.get_config("mpii_r18_384")
    jcfg = jax_configs.get_config("mpii_r18_384")
    rng = np.random.default_rng(0)
    ours, theirs = pckh.PCKhEvaluator(cfg.model), jax_pckh.PCKhEvaluator(
        jcfg.model)
    ds = SyntheticPoseDataset(cfg, size=6, seed=2, num_persons=3)
    P, K1 = cfg.model.max_instances, cfg.model.num_classes
    for i in range(len(ds)):
        s = ds[i]
        box = np.zeros((P, K1, 4), np.float32)
        kp_valid = np.zeros((P, K1), bool)
        n_gt = int(s["valid"].sum())
        box[:n_gt, 0] = s["bboxes"][:n_gt]
        box[:n_gt, 1:, :2] = s["keypoints"][:n_gt] + rng.normal(
            0, 6, (n_gt, K1 - 1, 2))
        kp_valid[:n_gt] = rng.random((n_gt, K1)) < 0.9
        fields = dict(kp_cell=np.zeros((P, K1, 2), np.int32), kp_box=box,
                      kp_score=rng.random((P, K1)).astype(np.float32),
                      kp_valid=kp_valid, valid=kp_valid[:, 0],
                      num_kp=kp_valid[:, 1:].sum(-1).astype(np.int32))
        hs = runner.synthetic_headsizes(s["bboxes"])
        np.testing.assert_array_equal(
            hs, jax_runner.synthetic_headsizes(s["bboxes"]))
        gt = (s["keypoints"], s["visible"], s["bboxes"], s["valid"], hs)
        ours.add_image(People(**fields), *gt)
        theirs.add_image(JaxPeople(**fields), *gt)
    assert ours.summarize() == theirs.summarize()
    assert 0 < ours.summarize()["pckh/mean"] < 1
    np.testing.assert_array_equal(
        pckh.headsize_from_bbox(np.array([[0, 0, 3, 4.0]])),
        jax_pckh.headsize_from_bbox(np.array([[0, 0, 3, 4.0]])))


def test_infinite_batches_match_jax():
    cfg, jcfg = configs.get_config("tiny_test"), jax_configs.get_config(
        "tiny_test")
    for size, bs in ((5, 2), (3, 4)):   # epochs, and sampling with replacement
        ours = pipeline.infinite_batches(
            SyntheticPoseDataset(cfg, size=size, seed=1), bs, seed=3,
            image_uint8=True)
        theirs = jax_pipeline.infinite_batches(
            JaxSynthetic(jcfg, size=size, seed=1), bs, seed=3,
            image_uint8=True)
        for _ in range(5):
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("assignments", [
    ["data.rotate_deg=20", "model.nms_thresh=0.45", "train.resume=false"],
    ["train.mesh_shape=(2, 4)", "model.edges=((0, 3), (3, 2))",
     "model.flip_pairs=()"],
    ["train.lr_schedule=step", "data.augment_dtype=float32"],
])
def test_overrides_match_jax(assignments):
    cfg = overrides.apply_overrides(configs.get_config("mpii_r18_384"),
                                    assignments)
    jcfg = jax_overrides.apply_overrides(
        jax_configs.get_config("mpii_r18_384"), assignments)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("bad", ["data.nope=1", "data", "train.resume=maybe",
                                 "model.edges=((0, 99),)"])
def test_overrides_reject_like_jax(bad):
    with pytest.raises(ValueError) as ours:
        overrides.apply_overrides(configs.get_config("tiny_test"), [bad])
    with pytest.raises(ValueError) as theirs:
        jax_overrides.apply_overrides(jax_configs.get_config("tiny_test"),
                                      [bad])
    assert str(ours.value) == str(theirs.value)


def test_metric_logger_matches_jax(tmp_path, capsys):
    metrics = {"loss_total": 1.25, "grad_norm": np.float32(3.5),
               "images_per_sec": 12}
    outs = []
    for mod, d in ((logging, tmp_path / "ours"), (jax_logging,
                                                  tmp_path / "theirs")):
        log = mod.MetricLogger(str(d))
        log.log(7, metrics)
        log.close()
        recs = [json.loads(line) for line in
                (d / "train_metrics.jsonl").read_text().splitlines()]
        for r in recs:
            r.pop("time")
        line = capsys.readouterr().out.strip()
        outs.append((recs, line[line.index("]") + 1:]))
    assert outs[0] == outs[1]
    assert outs[0][0] == [{"step": 7, "loss_total": 1.25, "grad_norm": 3.5,
                           "images_per_sec": 12.0}]
