"""The port's COCO OKS evaluation (``ppn_tpu_torch/eval/coco_eval.py``), its
evaluation loop (``eval/runner.py``) and its evaluate CLI
(``apps/evaluate.py``), against ``ppn_tpu/eval/coco_eval.py``,
``ppn_tpu/eval/runner.py`` and ``ppn_tpu/apps/evaluate.py`` on the CPU.

The evaluator is host numpy in float64 in both packages, so its summaries
must be equal with ``==``. The CLI tests follow
``tests/test_evaluate_cli.py``.
"""

import json

import numpy as np
import pytest
import torch
from test_eval import _gt, _people_from_gt

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from ppn_tpu.eval import coco_eval as jax_coco
from ppn_tpu.eval import runner as jax_runner
from ppn_tpu.ops.parse import People as JaxPeople
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.pipeline import epoch_batches
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.eval import coco_eval, runner
from ppn_tpu_torch.eval.coco_eval import OKSEvaluator, oks
from ppn_tpu_torch.ops import encode as enc
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COCO_SNAPSHOT = "artifacts/coco_hero_r3_ema_f16.npz"


# ---- oks and OKSEvaluator against the JAX package ---------------------------

def test_oks_matches_jax():
    """Seeded predictions and GT, visible and invisible keypoints, areas
    below the floor of 1, and GT with no visible keypoint."""
    rng = np.random.default_rng(0)
    values = []
    for case in range(40):
        K = 17 if case % 2 else 16
        sigmas = coco_eval.COCO_SIGMAS if K == 17 else np.full(K, 0.07)
        gt = rng.uniform(0, 384, (K, 2))
        pred = gt + rng.normal(0, 10 ** rng.uniform(-1, 2), (K, 2))
        vis = rng.integers(0, 3, K) * (case % 7 != 0)
        valid = rng.random(K) < 0.8
        area = float(rng.choice([0.25, 100.0, rng.uniform(1e2, 1e5)]))
        got = oks(pred, gt, vis, area, sigmas, valid)
        want = jax_coco.oks(pred, gt, vis, area, sigmas, valid)
        assert got == want
        values.append(got)
    assert values.count(0.0) >= 5 and any(0.1 < v < 0.9 for v in values)


def _random_image(m, rng, n_gt, n_pred, ties):
    """One image's port People and GT: predictions near some GT persons,
    some far off, scores drawn from a few values when ``ties``."""
    P, K1, K = m.max_instances, m.num_classes, m.num_keypoints
    kp = rng.uniform(20, 360, (P, K, 2)).astype(np.float32)
    vis = rng.integers(0, 3, (P, K)).astype(np.int32)
    vis[rng.random(P) < 0.1] = 0                  # persons with no visible kp
    valid = np.zeros(P, bool)
    valid[:n_gt] = True
    box = np.zeros((P, 4), np.float32)
    box[:, 2:] = rng.uniform(20, 200, (P, 2))
    kp_box = np.zeros((P, K1, 4), np.float32)
    kp_valid = np.zeros((P, K1), bool)
    for p in range(n_pred):
        src = rng.integers(0, max(n_gt, 1))
        kp_box[p, 1:, :2] = kp[src] + rng.normal(0, rng.choice([1, 5, 40]),
                                                 (K, 2))
        kp_valid[p] = rng.random(K1) < 0.85
        kp_valid[p, 0] = True
    score = (rng.choice([0.3, 0.5, 0.9], (P, K1)) if ties
             else rng.random((P, K1))).astype(np.float32)
    fields = dict(kp_cell=np.zeros((P, K1, 2), np.int32), kp_box=kp_box,
                  kp_score=score, kp_valid=kp_valid, valid=kp_valid[:, 0],
                  num_kp=kp_valid[:, 1:].sum(-1).astype(np.int32))
    return fields, (kp, vis, valid, box[:, 2] * box[:, 3])


@pytest.mark.parametrize("name", ["coco_r18_384", "mpii_r18_384",
                                  "tiny_test"])
@pytest.mark.parametrize("ties", [False, True])
def test_oks_evaluator_matches_jax(name, ties):
    """Seeded People and GT over 12 images, one of them empty (no GT, no
    prediction) and one with predictions but no GT; MPII and tiny_test take
    the uniform-sigma route. Tied scores must keep index order in both
    sorts, as the original's stable ``sorted`` does."""
    m, jm = get_config(name).model, jax_get_config(name).model
    ours, theirs = OKSEvaluator(m), jax_coco.OKSEvaluator(jm)
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    assert (len(ours.sigmas) == 17) == (name == "coco_r18_384")
    rng = np.random.default_rng(7 + ties)
    P = m.max_instances
    for i in range(12):
        n_gt = 0 if i in (3, 8) else int(rng.integers(1, min(P, 5) + 1))
        n_pred = 0 if i == 3 else int(rng.integers(1, P + 1))
        fields, gt = _random_image(m, rng, n_gt, n_pred, ties)
        ours.add_image(People(**fields), *gt)
        theirs.add_image(JaxPeople(**fields), *gt)
    got = ours.summarize()
    assert got == theirs.summarize()
    assert sorted(got) == ["oks/AP", "oks/AP50", "oks/AP75", "oks/num_gt"]
    assert 0 < got["oks/AP"] < 1


def test_oks_evaluator_empty_summaries_match_jax():
    """No detections, or no GT: three keys, all 0, as the original."""
    m, jm = get_config("coco_r18_384").model, jax_get_config(
        "coco_r18_384").model
    assert OKSEvaluator(m).summarize() == jax_coco.OKSEvaluator(
        jm).summarize() == {"oks/AP": 0.0, "oks/AP50": 0.0, "oks/AP75": 0.0}
    fields, (kp, vis, valid, areas) = _random_image(
        m, np.random.default_rng(0), 0, 3, False)
    ours, theirs = OKSEvaluator(m), jax_coco.OKSEvaluator(jm)
    ours.add_image(People(**fields), kp, vis, valid, areas)
    theirs.add_image(JaxPeople(**fields), kp, vis, valid, areas)
    assert ours.summarize() == theirs.summarize() == {
        "oks/AP": 0.0, "oks/AP50": 0.0, "oks/AP75": 0.0}


# ---- the cases of tests/test_eval.py, on the port's evaluator ---------------

def test_oks_identity_is_one():
    kp = np.random.default_rng(0).uniform(0, 100, (17, 2))
    vis = np.ones(17)
    v = oks(kp, kp, vis, area=5000.0, sigmas=coco_eval.COCO_SIGMAS,
            pred_valid=np.ones(17, bool))
    assert abs(v - 1.0) < 1e-9


def test_oks_ap_perfect():
    cfg = jax_get_config("coco_r18_384")
    kp, vis, box, valid, hs = _gt(cfg)
    areas = np.full((2,), 4e4, np.float32)
    ppl = People(*_people_from_gt(cfg, kp, vis, box))
    ev = OKSEvaluator(get_config("coco_r18_384").model)
    ev.add_image(ppl, kp, vis, valid, areas)
    s = ev.summarize()
    assert s["oks/AP"] > 0.99
    assert s["oks/AP50"] > 0.99


def test_oks_ap_false_positives_lower_ap():
    cfg = jax_get_config("coco_r18_384")
    m = get_config("coco_r18_384").model
    kp, vis, box, valid, hs = _gt(cfg)
    areas = np.full((2,), 4e4, np.float32)
    # a high-scoring garbage detection far from all GT
    kp_fp = kp.copy() + 10_000
    ppl_good = People(*_people_from_gt(cfg, kp, vis, box))
    ppl_fp = People(*_people_from_gt(cfg, np.concatenate([kp_fp[:1], kp]),
                                     np.concatenate([vis[:1], vis]),
                                     np.concatenate([box[:1] + 10_000, box])))
    ev_good = OKSEvaluator(m)
    ev_good.add_image(ppl_good, kp, vis, valid, areas)
    ev_fp = OKSEvaluator(m)
    ev_fp.add_image(ppl_fp, kp, vis, valid, areas)
    assert ev_fp.summarize()["oks/AP"] < ev_good.summarize()["oks/AP"]


def test_oks_ap_golden_three_detections():
    """Hand-computed AP pin for the 101-point interpolation: one image, 2
    GT; 3 detections in score order TP(0.9), FP(0.8), TP(0.7) with OKS in
    {0, 1}, so every threshold sees precision [1, 1/2, 2/3] at recall
    [1/2, 1/2, 1]; interpolated [1, 2/3, 2/3]; AP = (51·1 + 50·(2/3)) / 101
    = 253/303 at all 10 thresholds."""
    m = get_config("coco_r18_384").model
    kp, vis, box, valid, hs = _gt(jax_get_config("coco_r18_384"), n=2)
    areas = np.full((2,), 4e4, np.float32)
    P, K1 = m.max_instances, m.num_classes
    kp_box = np.zeros((P, K1, 4), np.float32)
    kp_score = np.zeros((P, K1), np.float32)
    kp_valid = np.zeros((P, K1), bool)
    pvalid = np.zeros((P,), bool)
    for p, (src, score) in enumerate([(0, 0.9), (None, 0.8), (1, 0.7)]):
        kp_score[p, 0] = score
        kp_valid[p, 0] = True
        pvalid[p] = True
        kp_valid[p, 1:] = True
        kp_box[p, 1:, :2] = 1e6 if src is None else kp[src]
    ppl = People(np.zeros((P, K1, 2), np.int32), kp_box, kp_score,
                 kp_valid, pvalid, kp_valid[:, 1:].sum(-1).astype(np.int32))
    ev = OKSEvaluator(m)
    ev.add_image(ppl, kp, vis, valid, areas)
    s = ev.summarize()
    golden = 253.0 / 303.0
    assert abs(s["oks/AP"] - golden) < 1e-12, s["oks/AP"]
    assert abs(s["oks/AP50"] - golden) < 1e-12
    assert abs(s["oks/AP75"] - golden) < 1e-12
    assert s["oks/num_gt"] == 2.0


# ---- the evaluation loop against the JAX package's --------------------------

def _noisy_oracle_maps(cfg, dataset, bs, seed=0):
    """One feature map per padded batch of ``dataset`` in the loop's order:
    the batch's GT encoded as a map, plus N(0, 0.3) logit noise, so the
    parsed persons land near, not on, their GT."""
    rng = np.random.default_rng(seed)
    maps = []
    for batch in epoch_batches(dataset, bs, rng=np.random.default_rng(0),
                               shuffle=False, drop_remainder=False):
        batch, _ = runner.pad_batch(batch, bs)
        t = enc.encode_batch(cfg.model, *(torch.from_numpy(batch[k]) for k in
                                          ("keypoints", "visible", "bboxes",
                                           "valid")))
        fm = enc.targets_to_feature_map(cfg.model, t).numpy()
        maps.append((fm + rng.normal(0, 0.3, fm.shape)).astype(np.float32))
    return maps


@pytest.mark.parametrize("metric", ["pckh", "oks"])
@pytest.mark.parametrize("max_images", [10, 6])
def test_evaluate_matches_jax_on_the_same_maps(metric, max_images):
    """10 tiny_test images at batch 4: a trailing partial batch of 2, padded
    to 4 by repeating its first row, whose padded rows must not be scored;
    and a cut after 6 images, inside the second batch. JAX's forward
    returns each batch's map; the port's returns the plain post-process of
    the same map. Every call sees batch size 4."""
    cfg, jcfg = get_config("tiny_test"), jax_get_config("tiny_test")
    ds = SyntheticPoseDataset(cfg, size=10, seed=0)
    maps = _noisy_oracle_maps(cfg, ds, 4)
    shapes = []

    def port_forward(images):
        shapes.append(images.shape)
        fm = torch.from_numpy(maps[len(shapes) - 1])
        return People(*(t.numpy() for t in postprocess_batch_plain(
            cfg.model, fm)))

    jax_calls = []

    def jax_forward(state, images):
        jax_calls.append(images.shape)
        return maps[len(jax_calls) - 1]

    ours = getattr(runner, f"evaluate_{metric}")(
        cfg, port_forward, ds, max_images=max_images, batch_size=4)
    theirs = getattr(jax_runner, f"evaluate_{metric}")(
        jcfg, jax_forward, None, JaxSynthetic(jcfg, size=10, seed=0),
        max_images=max_images, batch_size=4)
    assert shapes == jax_calls == [(4, *cfg.model.insize, 3)] * (
        3 if max_images == 10 else 2)
    assert ours == theirs
    if metric == "oks":
        n_gt = sum(int(ds[i]["valid"].sum()) for i in range(
            8 if max_images == 6 else 10))
        assert ours["oks/num_gt"] == n_gt and 0 < ours["oks/AP"] < 1
    else:
        assert 0 < ours["pckh/mean"] < 1


# ---- the evaluate CLI -------------------------------------------------------

def _summary(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_evaluate_cli_on_a_trained_checkpoint(tmp_path, capsys):
    """The port's train CLI, 2 steps of tiny_test, then its evaluate CLI on
    the checkpoint: PCKh, with thresholds and --flip-tta, and OKS (the
    cases of tests/test_evaluate_cli.py)."""
    from ppn_tpu_torch.apps import evaluate, train

    ckpt = tmp_path / "ckpt"
    train.main(["--device", "cpu", "--config", "tiny_test", "--overfit", "2",
                "--steps", "2", "--ckpt-dir", str(ckpt), "--no-resume"])
    capsys.readouterr()
    base = ["--device", "cpu", "--config", "tiny_test", "--ckpt-dir",
            str(ckpt), "--data", "synthetic"]
    got = evaluate.main(base + ["--max-images", "4", "--batch-size", "2"])
    captured = capsys.readouterr()
    assert _summary(captured.out) == got
    assert f"loaded {ckpt}" in captured.err
    assert 0.0 <= got["pckh/mean"] <= 1.0

    evaluate.main(base + ["--max-images", "2", "--batch-size", "2",
                          "--detection-thresh", "0.05", "--nms-thresh",
                          "0.45", "--flip-tta"])
    assert "pckh/mean" in _summary(capsys.readouterr().out)

    evaluate.main(base + ["--max-images", "4", "--batch-size", "2",
                          "--metric", "oks"])
    got = _summary(capsys.readouterr().out)
    assert 0.0 <= got["oks/AP"] <= 1.0


@pytest.mark.parametrize("metric", ["oks", "pckh"])
def test_evaluate_cli_matches_jax_on_the_coco_snapshot(metric, capsys):
    """Both CLIs on the committed COCO snapshot over 4 held-out images at
    batch 2: the same JSON."""
    from ppn_tpu.apps import evaluate as jax_evaluate
    from ppn_tpu_torch.apps import evaluate

    argv = ["--config", "coco_r18_384", "--ckpt-dir", COCO_SNAPSHOT,
            "--metric", metric, "--num-persons", "2", "--max-images", "4",
            "--batch-size", "2", "--detection-thresh", "0.02",
            "--nms-thresh", "0.6"]
    jax_evaluate.main(argv)
    want = _summary(capsys.readouterr().out)
    evaluate.main(argv + ["--device", "cpu"])
    assert _summary(capsys.readouterr().out) == want
    assert want["oks/num_gt" if metric == "oks" else "pckh/num_joints"] > 0


def test_evaluate_cli_refuses_the_real_data_loaders(tmp_path):
    """The loaders are ported (tests/test_torch_real_data_cli.py runs them):
    a tree without annotation files is refused with the JAX package's
    FileNotFoundError, no longer with NotImplementedError."""
    from ppn_tpu_torch.apps import evaluate

    for data, match in (("mpii", "no MPII annotation json"),
                        ("coco", "no COCO person_keypoints")):
        with pytest.raises(FileNotFoundError, match=match):
            evaluate.main(["--device", "cpu", "--config", "tiny_test",
                           "--data", data, "--data-root", str(tmp_path)])
