"""The three committed inference snapshots, loaded into the port, must
reproduce the PCKh pinned for the JAX package in
tests/test_committed_{,mpii_,crowd_}checkpoint.py: the same configs and
thresholds, the same 16 held-out synthetic images, batch 8, on the CPU.
The COCO snapshots must reproduce the JAX package's OKS AP on the same
protocol, scored from the same forward passes.

Tolerance: |Δ| < 3e-3, the pinned tests' own, for PCKh and OKS AP alike:
the port's bf16 logits on the CPU are not bitwise XLA's, and a logit ulp
can reorder two detections of nearly equal score (the COCO snapshot's AP
moves by 1.03e-4 so). The counts of joints and GT persons depend only on
the GT and must be equal. On the JAX package's own logits, the port's
post-process and OKS evaluation give its AP exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.synthetic import heldout_dataset
from ppn_tpu_torch.eval.runner import evaluate_oks, evaluate_pckh
from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
from ppn_tpu_torch.utils.params_io import load_inference_npz
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


# OKS AP of the JAX package on the same protocol (its make_forward through
# eval/runner.evaluate_oks on its CPU), and the GT persons scored:
# (snapshot, flip-TTA) -> (AP, num_gt)
PINNED_OKS = {
    ("coco", False): (0.9451339658485332, 32),
    ("coco", True): (0.9724083272250101, 32),
    ("crowd", False): (0.8628408208746722, 80),
}


def _config(which):
    name, _, _, thresholds, _, _ = SNAPSHOTS[which]
    cfg = get_config(name)
    if thresholds is not None:
        det, nms = thresholds
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, detection_thresh=det, nms_thresh=nms))
    return cfg


@pytest.fixture(scope="module")
def protocol():
    """``(which, flip_tta) -> (cfg, forward, held-out set)``. Each forward
    keeps the People of every batch it ran, so the PCKh and OKS pins of a
    snapshot score the same forward passes."""
    made = {}

    def get(which, flip_tta=False):
        if (which, flip_tta) not in made:
            cfg = _config(which)
            _, snap, persons, _, _, _ = SNAPSHOTS[which]
            pred = Predictor.from_npz(cfg, os.path.join(ARTIFACTS, snap),
                                      device="cpu", flip_tta=flip_tta)
            ran = {}

            def forward(images):
                key = images.tobytes()
                if key not in ran:
                    ran[key] = pred.predict(images)
                return ran[key]

            made[which, flip_tta] = (cfg, forward, heldout_dataset(
                cfg, num_persons=persons))
        return made[which, flip_tta]

    return get


@pytest.mark.parametrize("which", sorted(SNAPSHOTS))
def test_snapshot_reproduces_pinned_pckh(which, protocol):
    *_, pinned, joints = SNAPSHOTS[which]
    summary = evaluate_pckh(*protocol(which), max_images=16, batch_size=8)
    assert abs(summary["pckh/mean"] - pinned) < 3e-3, summary
    assert summary["pckh/num_joints"] == joints


def test_snapshot_flip_tta_reproduces_jax_pckh(protocol):
    """Flip-TTA on the MPII snapshot and the same protocol: the JAX
    package's TTA forward (``train/steps.make_forward(flip_tta=True)``
    through ``eval/runner.evaluate_pckh``) gives 0.98942 over 378 joints on
    the CPU, one joint fewer than without TTA; the port must reproduce it,
    not improve on it."""
    *_, joints = SNAPSHOTS["mpii"]
    summary = evaluate_pckh(*protocol("mpii", True), max_images=16,
                            batch_size=8)
    assert abs(summary["pckh/mean"] - 0.98942) < 3e-3, summary
    assert summary["pckh/num_joints"] == joints


@pytest.mark.parametrize("which,flip_tta", sorted(PINNED_OKS))
def test_snapshot_reproduces_jax_oks(which, flip_tta, protocol):
    pinned, num_gt = PINNED_OKS[which, flip_tta]
    summary = evaluate_oks(*protocol(which, flip_tta), max_images=16,
                           batch_size=8)
    assert abs(summary["oks/AP"] - pinned) < 3e-3, summary
    assert summary["oks/num_gt"] == num_gt


def test_snapshot_oks_on_jax_logits_is_exact():
    """The JAX package's own feature maps of the COCO snapshot, through the
    port's plain post-process and OKS evaluation: its AP, to the bit."""
    from ppn_tpu.configs import get_config as jax_get_config
    from ppn_tpu.train.steps import make_forward
    from ppn_tpu.utils.params_io import load_inference_npz as jax_load

    cfg = _config("coco")
    jcfg = jax_get_config(cfg.name)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, detection_thresh=cfg.model.detection_thresh,
        nms_thresh=cfg.model.nms_thresh))
    graphdef, state = jax_load(jcfg, os.path.join(ARTIFACTS,
                                                  SNAPSHOTS["coco"][1]))
    jax_forward = make_forward(jcfg, graphdef)

    def forward(images):
        fm = torch.from_numpy(np.array(jax_forward(state, images)))
        return People(*(t.numpy() for t in postprocess_batch_plain(
            cfg.model, fm)))

    summary = evaluate_oks(cfg, forward, heldout_dataset(cfg, num_persons=2),
                           max_images=16, batch_size=8)
    assert (summary["oks/AP"], summary["oks/num_gt"]) == PINNED_OKS[
        "coco", False]


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
