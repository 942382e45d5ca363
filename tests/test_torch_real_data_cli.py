"""The port's train and evaluate CLIs on MPII and COCO files, on the CPU
(``--device cpu``): the cases of tests/test_real_data_cli.py, a tree
without a validation split, and the committed MPII snapshot's PCKh on the
16-image protocol written as PNG files, pinned to the JAX package's value
on those files."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
# the JAX package's PCKh of the snapshot on the PNG set (make_forward
# through eval/runner.evaluate_pckh, det 0.02, nms 0.45) and its joints
PINNED_FILE_PCKH, PINNED_JOINTS = 0.9761904761904762, 378


@pytest.fixture
def mpii_root(tmp_path):
    """tests/test_real_data_cli.py's MPII fixture."""
    root = tmp_path / "mpii"
    (root / "images").mkdir(parents=True)
    (root / "annot").mkdir()
    rng = np.random.default_rng(3)
    records = []
    for i in range(4):
        name = f"img_{i}.jpg"
        Image.fromarray(
            rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)).save(
                root / "images" / name)
        records.append({
            "image": name,
            "joints": rng.uniform([5, 5], [155, 115], size=(16, 2)).tolist(),
            "joints_vis": [1] * 16,
            "center": [80, 60],
            "scale": 0.6,
            "headbox": [60, 10, 100, 40],
        })
    with open(root / "annot" / "train.json", "w") as f:
        json.dump(records, f)
    with open(root / "annot" / "valid.json", "w") as f:
        json.dump(records[:2], f)
    return str(root)


@pytest.fixture
def coco_root(tmp_path):
    """tests/test_real_data_cli.py's COCO fixture."""
    root = tmp_path / "coco"
    (root / "train2017").mkdir(parents=True)
    (root / "val2017").mkdir()
    (root / "annotations").mkdir()
    rng = np.random.default_rng(4)
    images, anns = [], []
    for i in range(4):
        name = f"c_{i}.jpg"
        img = Image.fromarray(
            rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
        img.save(root / "train2017" / name)
        img.save(root / "val2017" / name)
        images.append({"id": i, "file_name": name,
                       "width": 160, "height": 120})
        kps = []
        for _ in range(17):
            kps += [float(rng.uniform(5, 155)), float(rng.uniform(5, 115)),
                    2]
        anns.append({"id": 100 + i, "image_id": i, "category_id": 1,
                     "iscrowd": 0, "num_keypoints": 17, "keypoints": kps,
                     "bbox": [10.0, 10.0, 120.0, 90.0], "area": 10800.0})
    blob = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}
    for split in ("train2017", "val2017"):
        with open(root / "annotations"
                  / f"person_keypoints_{split}.json", "w") as f:
            json.dump(blob, f)
    return str(root)


def _summary(out: str) -> dict:
    return json.loads(out[out.index("{"):])


@pytest.mark.parametrize("cache", ["on", "off"])
def test_train_and_evaluate_cli_on_mpii_files(mpii_root, tmp_path, capsys,
                                              cache):
    """Two steps on the files, held on the device or streamed through the
    host pipeline (``headsizes`` ride along and are ignored), a checkpoint,
    ``eval:`` over the validation split, then the evaluate CLI on the
    checkpoint."""
    from ppn_tpu_torch.apps import evaluate as eval_app
    from ppn_tpu_torch.apps import train as train_app

    ck = str(tmp_path / "ck")
    train_app.main([
        "--device", "cpu", "--config", "tiny_test", "--data", "mpii",
        "--data-root", mpii_root, "--steps", "2", "--batch-size", "2",
        "--ckpt-dir", ck, "--no-resume", "--device-cache", cache])
    out = capsys.readouterr().out
    assert ("device cache: 4 samples" in out) == (cache == "on")
    assert "eval:" in out and os.listdir(ck) == ["ckpt_00000002.pt"]
    eval_app.main([
        "--device", "cpu", "--config", "tiny_test", "--data", "mpii",
        "--data-root", mpii_root, "--ckpt-dir", ck, "--max-images", "2",
        "--batch-size", "2"])
    summary = _summary(capsys.readouterr().out)
    assert "pckh/mean" in summary and summary["pckh/num_joints"] > 0


def test_train_and_evaluate_cli_on_coco_files(coco_root, tmp_path, capsys):
    from ppn_tpu_torch.apps import evaluate as eval_app
    from ppn_tpu_torch.apps import train as train_app

    small = ["--set", "model.insize=(64, 64)",
             "--set", "model.outsize=(2, 2)",
             "--set", "model.local_grid_size=(3, 3)",
             "--set", "model.max_instances=4",
             "--set", "train.warmup_steps=2"]
    ck = str(tmp_path / "ck")
    train_app.main([
        "--device", "cpu", "--config", "coco_r18_384", "--data", "coco",
        "--data-root", coco_root, "--steps", "2", "--batch-size", "2",
        "--ckpt-dir", ck, "--no-resume", *small])
    assert "eval:" in capsys.readouterr().out
    eval_app.main([
        "--device", "cpu", "--config", "coco_r18_384", "--data", "coco",
        "--data-root", coco_root, "--ckpt-dir", ck, "--max-images", "2",
        "--batch-size", "2", "--metric", "oks", *small])
    summary = _summary(capsys.readouterr().out)
    assert "oks/AP" in summary


def test_cli_on_a_tree_without_validation_split(mpii_root, tmp_path,
                                                capsys):
    """The train CLI runs and prints no ``eval:``; the evaluate CLI exits
    with the reference's message."""
    from ppn_tpu_torch.apps import evaluate as eval_app
    from ppn_tpu_torch.apps import train as train_app

    os.remove(os.path.join(mpii_root, "annot", "valid.json"))
    argv = ["--device", "cpu", "--config", "tiny_test", "--data", "mpii",
            "--data-root", mpii_root]
    train_app.main(argv + ["--steps", "1", "--batch-size", "2",
                           "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "final:" in out and "eval:" not in out
    with pytest.raises(SystemExit, match="no validation split"):
        eval_app.main(argv)


def test_evaluate_cli_pins_the_snapshot_on_png_files(tmp_path, capsys):
    """The committed MPII snapshot through the evaluate CLI on the 16
    held-out protocol images written as PNGs in MPII layout
    (``testing.write_mpii_set``): the JAX package's PCKh on the same files
    (equal on this CPU; held within 3e-3, the other PCKh pins' tolerance)
    over exactly 378 joints."""
    from ppn_tpu_torch.apps import evaluate as eval_app
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import heldout_dataset
    from ppn_tpu_torch.testing import write_mpii_set

    cfg = get_config("mpii_r18_384")
    held = heldout_dataset(cfg, num_persons=2)
    write_mpii_set(cfg, str(tmp_path), {"train": (held, 16, 0),
                                        "valid": (held, 16, 0)})
    summary = eval_app.main([
        "--device", "cpu", "--config", "mpii_r18_384", "--data", "mpii",
        "--data-root", str(tmp_path), "--ckpt-dir", SNAPSHOT,
        "--max-images", "16", "--batch-size", "8",
        "--detection-thresh", "0.02", "--nms-thresh", "0.45"])
    assert _summary(capsys.readouterr().out) == summary
    assert abs(summary["pckh/mean"] - PINNED_FILE_PCKH) < 3e-3
    assert summary["pckh/num_joints"] == PINNED_JOINTS
