"""The port's file loaders (ppn_tpu_torch/data/{imageio,mpii,coco}.py and
apps/video.jpeg_frames) against the JAX package's on the same files, on the
CPU: every field of every sample bitwise equal to ``ppn_tpu.data.{mpii,
coco}`` at both packages' default, ``native_jpeg=True`` (JPEGs through the
native libjpeg pool, other files through PIL), and through PIL with
``native_jpeg=False``; without the native library the native path raises
instead of falling back to PIL. The cases of tests/test_datasets.py, each
also held against the reference."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data import coco as jcoco
from ppn_tpu.data import mpii as jmpii
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data import coco, mpii
from ppn_tpu_torch.data.imageio import load_resized
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (H, W) of the written originals: downscaled to 384², and upscaled
SIZES = {"down": (240, 320), "up": (120, 160)}


def assert_same_samples(got_ds, want_ds):
    """Every sample of the port's dataset bitwise the reference's, each
    read through its package's default decoding (native for JPEGs)."""
    assert got_ds.native_jpeg and want_ds.native_jpeg
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            assert g.tobytes() == w.tobytes(), (i, k)


def _image(rng, hw, path):
    Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
        path)


# ---- MPII -------------------------------------------------------------------

def _mpii_tree(root, ext="jpg", hw=(240, 320)):
    """tests/test_datasets.py's fixture at a given file type and size."""
    (root / "images").mkdir(parents=True)
    (root / "annot").mkdir()
    rng = np.random.default_rng(0)
    H, W = hw
    records = []
    for i in range(3):
        name = f"img_{i}.{ext}"
        _image(rng, hw, root / "images" / name)
        for person in range(1 + i % 2):
            records.append({
                "image": name,
                "joints": rng.uniform([10, 10], [W - 10, H - 10],
                                      size=(16, 2)).tolist(),
                "joints_vis": [1] * 14 + [0, 1],
                "center": [W / 2, H / 2],
                "scale": 1.2 * H / 240,
                "headbox": [100, 20, 140, 60],
            })
    with open(root / "annot" / "train.json", "w") as f:
        json.dump(records, f)
    with open(root / "annot" / "valid.json", "w") as f:
        json.dump(records[:2], f)
    return str(root)


@pytest.fixture
def mpii_root(tmp_path):
    return _mpii_tree(tmp_path / "mpii")


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_mpii_dataset(tmp_path, ext, size):
    """tests/test_datasets.py::test_mpii_dataset, and both packages' train
    and val splits equal field by field."""
    root = _mpii_tree(tmp_path / "mpii", ext, SIZES[size])
    cfg = get_config("mpii_r18_384")
    train, val = mpii.make_mpii_datasets(cfg, root)
    assert len(train) == 3 and len(val) == 2
    s = train[1]
    m = cfg.model
    assert s["image"].shape == (*m.insize, 3)
    assert s["keypoints"].shape == (cfg.data.max_persons, m.num_keypoints, 2)
    assert s["valid"].sum() == 2  # img_1 has 2 persons
    kp, vis = s["keypoints"][s["valid"]], s["visible"][s["valid"]]
    assert np.all(kp[vis] >= 0) and np.all(kp[vis][:, 0] < m.insize[1])
    assert np.all(s["headsizes"][s["valid"]] > 0)
    cls = m.keypoint_names.index("r_ankle") - 1
    assert np.isfinite(s["keypoints"][0, cls]).all()
    jtrain, jval = jmpii.make_mpii_datasets(jax_get_config("mpii_r18_384"),
                                            root)
    assert_same_samples(train, jtrain)
    assert_same_samples(val, jval)


def test_mpii_center_scale_instance_box(mpii_root):
    """center/scale (a square of side 200·scale around center) defines the
    instance box, not the keypoint-extent heuristic."""
    cfg = get_config("mpii_r18_384")
    train, _ = mpii.make_mpii_datasets(cfg, mpii_root)
    s = train[0]  # center [160, 120], scale 1.2, image 320×240
    sx, sy = 384 / 320, 384 / 240
    np.testing.assert_allclose(
        s["bboxes"][0], [160 * sx, 120 * sy, 240 * sx, 240 * sy], rtol=1e-5)
    ext = mpii.MPIIDataset._instance_box(
        {}, s["keypoints"][0], s["visible"][0], sx, sy)
    assert not np.allclose(s["bboxes"][0], ext)
    assert ext == jmpii.MPIIDataset._instance_box(
        {}, s["keypoints"][0], s["visible"][0], sx, sy)


def test_mpii_center_scale_sentinel_falls_back(mpii_root, tmp_path):
    """center [-1, -1] / scale 0 records use the extent heuristic."""
    cfg = get_config("mpii_r18_384")
    with open(f"{mpii_root}/annot/train.json") as f:
        recs = json.load(f)
    recs[0]["center"] = [-1, -1]
    recs[0]["scale"] = 0
    ann = tmp_path / "sentinel.json"
    with open(ann, "w") as f:
        json.dump(recs[:1], f)
    ds = mpii.MPIIDataset(cfg, mpii_root, str(ann))
    s = ds[0]
    vpts = s["keypoints"][0][s["visible"][0]]
    cx, cy = (vpts.min(0) + vpts.max(0)) / 2
    np.testing.assert_allclose(s["bboxes"][0, :2], [cx, cy], rtol=1e-4)
    assert_same_samples(ds, jmpii.MPIIDataset(
        jax_get_config("mpii_r18_384"), mpii_root, str(ann)))


def test_mpii_overfit_mode(mpii_root):
    cfg = get_config("mpii_r18_384")
    train, val = mpii.make_mpii_datasets(cfg, mpii_root, overfit=2)
    assert len(train) == 2 and val is train
    jtrain, _ = jmpii.make_mpii_datasets(jax_get_config("mpii_r18_384"),
                                         mpii_root, overfit=2)
    assert_same_samples(train, jtrain)


def test_mpii_missing_annotations(tmp_path):
    cfg = get_config("mpii_r18_384")
    with pytest.raises(FileNotFoundError, match="MPII annotation") as got:
        mpii.make_mpii_datasets(cfg, str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jmpii.make_mpii_datasets(jax_get_config("mpii_r18_384"),
                                 str(tmp_path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("train_name,val_name", [
    ("annotations/train.json", "annotations/valid.json"),
    ("mpii_train.json", "val.json"),
    ("train.json", None)])
def test_mpii_annotation_file_names(mpii_root, tmp_path, train_name,
                                    val_name):
    """The candidate names in the reference's order; no validation file
    gives val None."""
    root = tmp_path / "renamed"
    os.makedirs(root / "images")
    for n in os.listdir(os.path.join(mpii_root, "images")):
        os.link(os.path.join(mpii_root, "images", n), root / "images" / n)
    with open(os.path.join(mpii_root, "annot", "train.json")) as f:
        recs = json.load(f)
    for name, part in ((train_name, recs), (val_name, recs[1:])):
        if name:
            os.makedirs(os.path.dirname(root / name), exist_ok=True)
            with open(root / name, "w") as f:
                json.dump(part, f)
    cfg = get_config("mpii_r18_384")
    train, val = mpii.make_mpii_datasets(cfg, str(root))
    jtrain, jval = jmpii.make_mpii_datasets(jax_get_config("mpii_r18_384"),
                                            str(root))
    assert len(train) == 3
    assert_same_samples(train, jtrain)
    if val_name is None:
        assert val is None and jval is None
    else:
        assert len(val) == 2
        assert_same_samples(val, jval)


@pytest.mark.parametrize("layout", ["root", "annotations", "data"])
def test_mpii_wrapped_layouts_and_name_keys(mpii_root, tmp_path, layout):
    """{"root"|"annotations"|"data": [...]} wrappers; the image under
    ``img_paths`` or ``im_name`` with a directory, grouped by basename; a
    record without an image name is skipped."""
    with open(f"{mpii_root}/annot/train.json") as f:
        recs = json.load(f)
    for i, r in enumerate(recs):
        key = ("image", "img_paths", "im_name")[i % 3]
        r[key] = "some/dir/" + r.pop("image")
    recs.append({"joints": recs[0]["joints"]})
    ann = tmp_path / "wrapped.json"
    with open(ann, "w") as f:
        json.dump({layout: recs}, f)
    ds = mpii.MPIIDataset(get_config("mpii_r18_384"), mpii_root, str(ann))
    assert ds.images == ["img_0.jpg", "img_1.jpg", "img_2.jpg"]
    assert_same_samples(ds, jmpii.MPIIDataset(
        jax_get_config("mpii_r18_384"), mpii_root, str(ann)))
    with open(ann, "w") as f:
        json.dump({"people": recs}, f)
    with pytest.raises(ValueError, match="unrecognized MPII annotation"):
        mpii.load_annotations(str(ann))


def test_mpii_headsize_rules_and_slots(tmp_path):
    """The head-size rules in order (head box; head segment; the tight
    keypoint extent), a center of -1, a person with no visible joint (its
    slot stays empty), joints at 0 counted invisible, and max_persons
    truncation — against the reference."""
    root = tmp_path / "rules"
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(7)
    _image(rng, (240, 320), root / "images" / "a.png")
    _image(rng, (240, 320), root / "images" / "b.png")

    def rec(image, **kw):
        joints = rng.uniform([20, 20], [300, 220], size=(16, 2))
        out = {"image": image, "joints": joints.tolist(),
               "joints_vis": [1] * 16, "center": [160, 120], "scale": 1.1}
        out.update(kw)
        return out

    no_neck = [1] * 16
    no_neck[8] = 0
    records = [
        rec("a.png", headbox=[90, 10, 150, 70]),     # head box
        rec("a.png"),                                # head segment
        rec("a.png", joints_vis=no_neck),            # keypoint extent
        rec("a.png", center=[-1, -1], joints_vis=no_neck),
        rec("a.png", joints_vis=[0] * 16),           # no visible joint
        rec("a.png", joints=[[0.0, 5.0]] * 8 + [[40.0, 0.0]] * 8),
    ] + [rec("b.png") for _ in range(13)]            # over max_persons
    ann = root / "train.json"
    with open(ann, "w") as f:
        json.dump(records, f)
    cfg = get_config("mpii_r18_384")
    ds = mpii.MPIIDataset(cfg, str(root), "train.json")
    a, b = ds[0], ds[1]
    assert a["valid"].tolist()[:6] == [True] * 4 + [False, False]
    assert (a["headsizes"][:4] > 0).all() and a["headsizes"][4] == 0
    assert b["valid"].sum() == cfg.data.max_persons
    assert_same_samples(ds, jmpii.MPIIDataset(
        jax_get_config("mpii_r18_384"), str(root), "train.json"))


def test_mpii_headsize_fallback_uses_keypoint_extent(tmp_path):
    """A record with center/scale but no head box and no head segment gets
    its PCKh threshold from the tight keypoint extent, not the 200·scale
    instance box."""
    root = tmp_path / "mpii2"
    (root / "images").mkdir(parents=True)
    (root / "annot").mkdir()
    Image.fromarray(np.zeros((240, 320, 3), np.uint8)).save(
        root / "images" / "a.jpg")
    joints = [[100 + 5 * i, 100 + 3 * i] for i in range(16)]
    jv = [1] * 16
    jv[8] = 0
    rec = {"image": "a.jpg", "joints": joints, "joints_vis": jv,
           "center": [160, 120], "scale": 1.5}
    with open(root / "annot" / "train.json", "w") as f:
        json.dump([rec], f)
    ds = mpii.MPIIDataset(get_config("mpii_r18_384"), str(root),
                          "annot/train.json")
    s = ds[0]
    hs = float(s["headsizes"][0])
    box_diag_based = 0.2 * float(np.hypot(*s["bboxes"][0, 2:4]))
    kp = s["keypoints"][0][s["visible"][0]]
    ext_based = 0.2 * float(np.hypot(
        max(kp[:, 0].max() - kp[:, 0].min(), 8.0) * 1.15,
        max(kp[:, 1].max() - kp[:, 1].min(), 8.0) * 1.15))
    assert abs(hs - ext_based) < 1e-3
    assert hs < box_diag_based * 0.8
    assert_same_samples(ds, jmpii.MPIIDataset(
        jax_get_config("mpii_r18_384"), str(root), "annot/train.json"))


# ---- COCO -------------------------------------------------------------------

def _coco_tree(root, ext="jpg", hw=(200, 300), year="2017", val=True):
    """tests/test_datasets.py's fixture at a given file type, size and
    year; the val annotations left out when ``val`` is False."""
    (root / "annotations").mkdir(parents=True)
    rng = np.random.default_rng(0)
    H, W = hw
    images, anns = [], []
    aid = 1
    for i in range(2):
        name = f"{i:012d}.{ext}"
        for d in (f"train{year}", f"val{year}"):
            (root / d).mkdir(exist_ok=True)
            _image(rng, hw, root / d / name)
        images.append({"id": i, "file_name": name, "width": W,
                       "height": H})
        for p in range(2):
            kps = []
            for k in range(17):
                kps += [float(rng.uniform(5, W - 5)),
                        float(rng.uniform(5, H - 5)), 2]
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "keypoints": kps, "num_keypoints": 17,
                         "bbox": [20, 20, W / 3, H * 0.75],
                         "area": W * H / 4, "iscrowd": 0})
            aid += 1
    blob = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}
    for split in (f"train{year}",) + ((f"val{year}",) if val else ()):
        with open(root / "annotations" /
                  f"person_keypoints_{split}.json", "w") as f:
            json.dump(blob, f)
    return str(root)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_coco_dataset(tmp_path, ext, size):
    """tests/test_datasets.py::test_coco_dataset, and both packages' train
    and val splits equal field by field (``areas`` included)."""
    root = _coco_tree(tmp_path / "coco", ext, SIZES[size])
    cfg = get_config("coco_r18_384")
    train, val = coco.make_coco_datasets(cfg, root)
    assert len(train) == 2 and len(val) == 2
    s = train[0]
    assert s["image"].shape == (*cfg.model.insize, 3)
    assert s["valid"].sum() == 2
    assert s["keypoints"].shape[1] == 17
    assert np.all(s["headsizes"][s["valid"]] > 0)
    assert np.all(s["areas"][s["valid"]] > 0)
    jtrain, jval = jcoco.make_coco_datasets(jax_get_config("coco_r18_384"),
                                            root)
    assert_same_samples(train, jtrain)
    assert_same_samples(val, jval)


def test_coco_end_to_end_encode(tmp_path):
    """A COCO sample goes through the port's encode with the coco config
    (K = 17, L = 17)."""
    from ppn_tpu_torch.ops import encode as enc

    cfg = get_config("coco_r18_384")
    train, _ = coco.make_coco_datasets(cfg, _coco_tree(tmp_path / "coco"))
    s = train[0]
    t = enc.encode_batch(cfg.model, *(torch.from_numpy(s[k][None]) for k in
                                      ("keypoints", "visible", "bboxes",
                                       "valid")))
    assert float(t.delta.sum()) > 0
    assert t.te.shape[3] == cfg.model.num_limbs


@pytest.mark.parametrize("min_keypoints", [1, 5])
def test_coco_filters_and_fallbacks(tmp_path, min_keypoints):
    """iscrowd skipped, num_keypoints below min_keypoints skipped, a missing
    area taken as bw·bh, a person with no visible keypoint left out of its
    slot, and the head size 0.1 · the box diagonal when the nose and ears
    coincide — against the reference."""
    root = tmp_path / "coco"
    (root / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.default_rng(5)
    _image(rng, (240, 320), root / "val2017" / "a.png")
    _image(rng, (240, 320), root / "val2017" / "b.png")

    def ann(image_id, n_vis=17, **kw):
        kps = []
        for k in range(17):
            kps += [float(rng.uniform(5, 315)), float(rng.uniform(5, 235)),
                    2 if k < n_vis else 0]
        out = {"id": len(anns) + 1, "image_id": image_id,
               "category_id": 1, "keypoints": kps, "num_keypoints": n_vis,
               "bbox": [30.5, 12.0, 140.0, 200.0], "area": 21000.0,
               "iscrowd": 0}
        out.update(kw)
        return out

    anns = []
    for image_id, kw in ((0, {}), (0, {"iscrowd": 1}), (0, {"n_vis": 3}),
                         (0, {"n_vis": 0}), (0, {}),
                         (1, {"keypoints": [100.0, 100.0, 2] * 5
                              + [float(v) for v in range(36)]}),
                         (1, {"num_keypoints": 2, "keypoints": [0.0] * 51})):
        anns.append(ann(image_id, **kw))
    del anns[4]["area"]
    blob = {"images": [{"id": 0, "file_name": "a.png"},
                       {"id": 1, "file_name": "b.png"}],
            "annotations": anns, "categories": [{"id": 1}]}
    with open(root / "annotations" / "v.json", "w") as f:
        json.dump(blob, f)
    cfg = get_config("coco_r18_384")
    ds = coco.COCOKeypointsDataset(cfg, str(root), "annotations/v.json",
                                   "val2017", min_keypoints=min_keypoints)
    want = jcoco.COCOKeypointsDataset(
        jax_get_config("coco_r18_384"), str(root), "annotations/v.json",
        "val2017", min_keypoints=min_keypoints)
    kept = [a["id"] for a in ds.by_image[0]]
    assert kept == ([1, 3, 5] if min_keypoints == 1 else [1, 5])
    assert_same_samples(ds, want)
    s = ds[1]
    sx, sy = 384 / 320, 384 / 240
    assert s["headsizes"][0] == np.float32(0.1 * np.hypot(140 * sx,
                                                          200 * sy))
    if min_keypoints == 1:
        assert ds[0]["areas"][2] == np.float32(140.0 * 200.0 * sx * sy)


def test_coco_file_names_and_splits(tmp_path):
    """The 2014 pair when no 2017 file exists; val None without its file;
    overfit=2 returns the train set twice; no annotations raise."""
    cfg, jcfg = get_config("coco_r18_384"), jax_get_config("coco_r18_384")
    root = _coco_tree(tmp_path / "c14", year="2014", val=False)
    train, val = coco.make_coco_datasets(cfg, root)
    jtrain, jval = jcoco.make_coco_datasets(jcfg, root)
    assert train.image_dir.endswith("train2014") and val is None is jval
    assert_same_samples(train, jtrain)
    root = _coco_tree(tmp_path / "c17")
    train, val = coco.make_coco_datasets(cfg, root, overfit=1)
    assert len(train) == 1 and val is train
    assert_same_samples(train, jcoco.make_coco_datasets(jcfg, root,
                                                        overfit=1)[0])
    with pytest.raises(FileNotFoundError, match="person_keypoints") as got:
        coco.make_coco_datasets(cfg, str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jcoco.make_coco_datasets(jcfg, str(tmp_path))
    assert str(got.value) == str(want.value)


# ---- decoding: native for JPEGs by default, PIL by name, no fallback --------

@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_load_resized_matches_jax(tmp_path, ext):
    """Both decoders, each bitwise the reference's: the default (native for
    a JPEG, PIL for a PNG) and ``native_jpeg=False`` (PIL)."""
    from ppn_tpu.data.imageio import load_resized as jax_load_resized

    rng = np.random.default_rng(1)
    for hw in SIZES.values():
        path = str(tmp_path / f"x{hw[0]}.{ext}")
        _image(rng, hw, path)
        for native in (True, False):
            got, W0, H0 = (load_resized(path, (96, 128)) if native else
                           load_resized(path, (96, 128), native_jpeg=False))
            want, jW0, jH0 = jax_load_resized(path, (96, 128),
                                              native_jpeg=native)
            assert (W0, H0) == (jW0, jH0) == (hw[1], hw[0])
            assert got.dtype == np.float32 and got.shape == (96, 128, 3)
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("where", ["load_resized_jpg", "load_resized_png",
                                   "mpii", "coco"])
def test_native_jpeg_raises_and_never_falls_back(tmp_path, where,
                                                 monkeypatch):
    """Without the native library (no ``pillow.libs`` where the loader
    looks, and nothing loaded yet), ``native_jpeg=True`` raises naming the
    cause for a JPEG, directly and through both datasets, instead of
    decoding it through PIL; a PNG never needed the library and still
    decodes through PIL, bitwise the reference's."""
    from ppn_tpu.data.imageio import load_resized as jax_load_resized
    from ppn_tpu_torch.native import loader

    missing = tmp_path / "no_site" / "pillow.libs"
    monkeypatch.setattr(loader, "pillow_libs", lambda: missing)
    monkeypatch.setattr(loader, "_lib", None)
    if where == "load_resized_png":
        path = str(tmp_path / "a.png")
        _image(np.random.default_rng(0), (8, 8), path)
        got = load_resized(path, (8, 8), native_jpeg=True)
        want = jax_load_resized(path, (8, 8), native_jpeg=True)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1:] == want[1:]
        return
    with pytest.raises(RuntimeError, match="no pillow.libs directory"):
        if where == "load_resized_jpg":
            path = str(tmp_path / "a.jpg")
            _image(np.random.default_rng(0), (8, 8), path)
            load_resized(path, (8, 8), native_jpeg=True)
        elif where == "mpii":
            root = _mpii_tree(tmp_path / "mpii")
            mpii.MPIIDataset(get_config("mpii_r18_384"), root,
                             "annot/train.json")[0]
        else:
            root = _coco_tree(tmp_path / "coco")
            coco.COCOKeypointsDataset(
                get_config("coco_r18_384"), root,
                "annotations/person_keypoints_val2017.json", "val2017")[0]
    assert loader._lib is None


def test_written_mpii_set_reads_back_the_synthetic_gt(tmp_path):
    """``testing.write_mpii_set`` on PNGs: the loader gives back the
    synthetic pixels, keypoints and visibility bitwise (joints away from
    the frame's 0 edge)."""
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.testing import write_mpii_set

    cfg = get_config("mpii_r18_384")
    src = SyntheticPoseDataset(cfg, size=4, seed=10_000, cache=True,
                               num_persons=2)
    write_mpii_set(cfg, str(tmp_path), {"train": (src, 4, 0)})
    train, val = mpii.make_mpii_datasets(cfg, str(tmp_path))
    assert val is None
    for i in range(4):
        got, want = train[i], src[i]
        assert np.array_equal(
            (got["image"] * 255.0 + 0.5).astype(np.uint8), want["image"])
        for k in ("keypoints", "visible", "valid"):
            assert got[k].tobytes() == want[k].tobytes(), (i, k)


# ---- the video directory source ---------------------------------------------

def test_jpeg_frames_match_jax(tmp_path):
    """The port's ``jpeg_frames`` against the reference's native pool path,
    frame by frame and bitwise, cycling three files of two sizes and a
    corrupt one to 9 frames in name order: the corrupt frames are skipped
    in both; a directory without JPEGs raises."""
    from ppn_tpu.apps import video as jvideo
    from ppn_tpu.native import loader
    from ppn_tpu_torch.apps import video

    assert loader.available()
    rng = np.random.default_rng(2)
    for name, hw in (("b.jpg", (240, 320)), ("a.JPEG", (120, 160)),
                     ("c.jpeg", (240, 320))):
        _image(rng, hw, tmp_path / name)
    (tmp_path / "z.jpg").write_bytes(b"not a jpeg")  # skipped when decoded
    _image(rng, (64, 64), tmp_path / "d.png")      # not a JPEG: not read
    got = list(video.jpeg_frames(str(tmp_path), 9, (96, 128)))
    want = list(jvideo.jpeg_frames(str(tmp_path), 9, (96, 128)))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (96, 128, 3)
        assert g.tobytes() == w.tobytes()
    assert got[0].tobytes() == got[3].tobytes() == got[6].tobytes()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(RuntimeError, match="no .jpg files"):
        next(video.jpeg_frames(str(empty), 2, (96, 128)))


@pytest.mark.parametrize("name", ["mpii_r18_384", "tiny_test"])
def test_mpii_joint_order_matches_jax(name):
    assert mpii._MPII_ORDER == jmpii._MPII_ORDER
    np.testing.assert_array_equal(
        mpii._remap_indices(get_config(name)),
        jmpii._remap_indices(jax_get_config(name)))
