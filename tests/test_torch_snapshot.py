"""The three committed inference snapshots, loaded into the port, must
reproduce the PCKh pinned for the JAX package in
tests/test_committed_{,mpii_,crowd_}checkpoint.py: the same configs and
thresholds, the same 16 held-out synthetic images, batch 8, on the CPU.

Tolerance: |Δ| < 3e-3, the pinned tests' own. The joint counts depend only
on the GT and must be equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.synthetic import heldout_dataset
from ppn_tpu_torch.eval.runner import evaluate_pckh
from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.utils.params_io import load_inference_npz

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")

# (config, snapshot, persons per image, det/nms override, PCKh, joints)
SNAPSHOTS = {
    "mpii": ("mpii_r18_384", "mpii_hero_r5_ema_f16.npz", 2, (0.02, 0.45),
             0.9921, 378),
    "coco": ("coco_r18_384", "coco_hero_r3_ema_f16.npz", 2, (0.02, 0.6),
             0.9756, 410),
    "crowd": ("coco_r18_384_crowded", "crowd_hero_r5_ema_f16.npz", 5, None,
              0.9249, 999),
}


@pytest.mark.parametrize("which", sorted(SNAPSHOTS))
def test_snapshot_reproduces_pinned_pckh(which):
    name, snap, persons, thresholds, pinned, joints = SNAPSHOTS[which]
    cfg = get_config(name)
    if thresholds is not None:
        det, nms = thresholds
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, detection_thresh=det, nms_thresh=nms))
    pred = Predictor.from_npz(cfg, os.path.join(ARTIFACTS, snap),
                              device="cpu")
    summary = evaluate_pckh(cfg, pred.predict,
                            heldout_dataset(cfg, num_persons=persons),
                            max_images=16, batch_size=8)
    assert abs(summary["pckh/mean"] - pinned) < 3e-3, summary
    assert summary["pckh/num_joints"] == joints


def test_snapshot_flip_tta_reproduces_jax_pckh():
    """Flip-TTA on the MPII snapshot and the same protocol: the JAX
    package's TTA forward (``train/steps.make_forward(flip_tta=True)``
    through ``eval/runner.evaluate_pckh``) gives 0.98942 over 378 joints on
    the CPU, one joint fewer than without TTA; the port must reproduce it,
    not improve on it."""
    name, snap, persons, (det, nms), _, joints = SNAPSHOTS["mpii"]
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=det, nms_thresh=nms))
    pred = Predictor.from_npz(cfg, os.path.join(ARTIFACTS, snap),
                              device="cpu", flip_tta=True)
    summary = evaluate_pckh(cfg, pred.predict,
                            heldout_dataset(cfg, num_persons=persons),
                            max_images=16, batch_size=8)
    assert abs(summary["pckh/mean"] - 0.98942) < 3e-3, summary
    assert summary["pckh/num_joints"] == joints


def test_snapshot_rejects_wrong_config():
    with pytest.raises(ValueError, match="leaves|shape"):
        load_inference_npz(get_config("mpii_r18_384"),
                           os.path.join(ARTIFACTS, "coco_hero_r3_ema_f16.npz"),
                           device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        load_inference_npz(get_config("mpii_r50_384"),
                           os.path.join(ARTIFACTS, "mpii_hero_r5_ema_f16.npz"),
                           device="cpu")


def test_snapshot_loads_f32_eval_model():
    model = load_inference_npz(
        get_config("mpii_r18_384"),
        os.path.join(ARTIFACTS, "mpii_hero_r5_ema_f16.npz"), device="cpu")
    assert not model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with np.load(os.path.join(ARTIFACTS, "mpii_hero_r5_ema_f16.npz")) as z:
        # the last leaf is rest.head.block.bn.var
        want = z["leaf_0106"].astype(np.float32)
    np.testing.assert_array_equal(
        model.head.block.bn.running_var.numpy(), want)


def test_predict_single_matches_batch():
    cfg = get_config("mpii_r18_384")
    pred = Predictor.from_npz(
        cfg, os.path.join(ARTIFACTS, "mpii_hero_r5_ema_f16.npz"),
        device="cpu")
    images = np.stack([heldout_dataset(cfg, 2)[i]["image"] for i in range(2)])
    batch = pred.predict(images[1:])    # same batch size: same conv sums
    one = pred.predict_single(images[1])
    for a, b in zip(batch, one):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a[0], b)
    with pytest.raises(ValueError, match="insize|expects"):
        pred.predict(images[:, :64, :64])
