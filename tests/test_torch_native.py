"""The port's native JPEG decode+resize pool (ppn_tpu_torch/native/) on the
CPU: the cases of tests/test_native_loader.py, and every output bitwise
equal to the JAX package's ``ppn_tpu.native.loader`` (the same loader.cc,
built with the same flags against the same libjpeg-turbo ABI): the one-shot
``decode_resize``, the header-only ``jpeg_dims``, the pool's frames, and
the MPII and COCO samples at their default ``native_jpeg=True`` — on a
1280×720 JPEG resized down to the model input, which the 384² protocol
files never exercise. Without its library the loader raises and names what
is missing; it never hands back PIL's pixels."""

import io
import json
import threading

import numpy as np
import pytest
from PIL import Image

from ppn_tpu.native import loader as ref
from ppn_tpu_torch.native import loader as nl
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jpeg_bytes(rng, h=240, w=320, quality=92):
    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _smooth_jpeg(h=240, w=320, quality=95, noise=0):
    """A smooth gradient (PIL's area filter and the plain bilinear resize
    agree closely on it), with ``noise`` levels of seeded noise added."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 255
    img += np.random.default_rng(h + w).uniform(-noise, noise, img.shape)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


# ---- tests/test_native_loader.py ----------------------------------------------

def test_native_builds_and_loads():
    assert nl.available(), "native loader failed to build (g++/libjpeg?)"
    assert nl.LIB.is_file() and nl.LIB.parent.name == "ppn_tpu_torch"
    assert ".so.62" in nl.libjpeg().name


def test_decode_resize_matches_pil():
    """The smooth image: PIL's antialiased downscale and the plain bilinear
    resize agree closely there (white noise would not)."""
    jpeg = _smooth_jpeg()
    out = nl.decode_resize(jpeg, (128, 160))
    assert out.shape == (128, 160, 3) and out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0
    img = Image.open(io.BytesIO(jpeg)).convert("RGB").resize(
        (160, 128), Image.BILINEAR)
    pil = np.asarray(img, np.float32) / 255.0
    assert np.abs(out - pil).mean() < 0.02
    assert np.corrcoef(out.ravel(), pil.ravel())[0, 1] > 0.98
    assert out.tobytes() == ref.decode_resize(jpeg, (128, 160)).tobytes()


def test_decode_identity_size_exact():
    """No resize (the output size is the source's): PIL's decode, to the
    last f32 bit of ×1/255 against /255."""
    jpeg = _jpeg_bytes(np.random.default_rng(1), h=64, w=64)
    out = nl.decode_resize(jpeg, (64, 64))
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"),
                     np.float32) / 255.0
    np.testing.assert_allclose(out, pil, rtol=0, atol=6e-8)
    assert out.tobytes() == ref.decode_resize(jpeg, (64, 64)).tobytes()


def test_corrupt_jpeg_raises():
    with pytest.raises(ValueError, match="decode failed"):
        nl.decode_resize(b"not a jpeg at all", (64, 64))
    with pytest.raises(ValueError, match="must be positive"):
        nl.decode_resize(_smooth_jpeg(16, 16), (0, 8))


def test_async_pool_out_of_order_ids():
    """Eight frames through three workers: every id back once, each frame
    bitwise the reference pool's for that id."""
    rng = np.random.default_rng(2)
    jpegs = {i: _jpeg_bytes(rng, h=100 + i, w=150) for i in range(8)}
    got, want = {}, {}
    for module, out in ((nl, got), (ref, want)):
        pool = module.NativeJpegLoader((96, 96), num_workers=3)
        try:
            for i, j in jpegs.items():
                pool.submit(i, j)
            for _ in jpegs:
                rid, frame = pool.get()
                assert frame is not None and frame.shape == (96, 96, 3)
                out[rid] = frame
            assert pool.pending() == 0
        finally:
            pool.close()
    assert set(got) == set(range(8))
    assert not np.array_equal(got[0], got[1])
    for i in jpegs:
        assert got[i].tobytes() == want[i].tobytes(), i


def test_async_pool_reports_failures():
    """A failed decode comes back as its id and no frame (the C side's
    -(id + 2)), between good ones."""
    pool = nl.NativeJpegLoader((32, 32), num_workers=1)
    try:
        pool.submit(5, b"garbage")
        pool.submit(0, _smooth_jpeg(40, 40))
        results = dict(pool.get() for _ in range(2))
        assert results[5] is None and results[0].shape == (32, 32, 3)
        with pytest.raises(ValueError, match="non-negative"):
            pool.submit(-1, b"")
    finally:
        pool.close()
    with pytest.raises(ValueError, match="at least 1"):
        nl.NativeJpegLoader((32, 32), num_workers=0)


def test_jpeg_dims_header_only():
    jpeg = _jpeg_bytes(np.random.default_rng(3), h=123, w=77)
    assert nl.jpeg_dims(jpeg) == ref.jpeg_dims(jpeg) == (77, 123)  # (W, H)
    with pytest.raises(ValueError, match="header unreadable"):
        nl.jpeg_dims(b"not a jpeg at all")


@pytest.mark.parametrize("dataset", ["mpii", "coco"])
def test_dataset_loads_jpeg_via_native(tmp_path, dataset):
    """A 1280×720 quality-95 JPEG resized down to the model input: each
    dataset's sample at the default (native) bitwise the reference's; the
    GT scaled by the original size with either decoder; the two decoders'
    pixels near on this smooth image but not equal (the native resize is
    half-pixel bilinear, PIL's area-filters on a downscale)."""
    from ppn_tpu.configs import get_config as jax_get_config
    from ppn_tpu.data import coco as jcoco
    from ppn_tpu.data import mpii as jmpii
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data import coco, mpii

    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "a.jpg").write_bytes(
        _smooth_jpeg(720, 1280, noise=40))
    joints = [[100.0 + 40 * i, 60.0 + 30 * i] for i in range(16)]
    if dataset == "mpii":
        name = "mpii_r18_384"
        (tmp_path / "train.json").write_text(json.dumps([{
            "image": "a.jpg", "joints": joints, "joints_vis": [1] * 16}]))

        def make(pkg, cfg, **kw):
            return pkg.MPIIDataset(cfg, str(tmp_path), "train.json", **kw)
        port, jax = mpii, jmpii
    else:
        name = "coco_r18_384"
        kps = sum(([x, y, 2] for x, y in joints[:17]), [])
        kps += [600.0, 500.0, 2] * (17 - len(joints))
        (tmp_path / "ann.json").write_text(json.dumps({
            "images": [{"id": 1, "file_name": "a.jpg", "width": 1280,
                        "height": 720}],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                             "keypoints": kps, "num_keypoints": 17,
                             "bbox": [80, 40, 800, 600], "area": 480000,
                             "iscrowd": 0}]}))

        def make(pkg, cfg, **kw):
            return pkg.COCOKeypointsDataset(cfg, str(tmp_path), "ann.json",
                                            "images", **kw)
        port, jax = coco, jcoco
    cfg, jcfg = get_config(name), jax_get_config(name)
    got, want = make(port, cfg)[0], make(jax, jcfg)[0]
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    pil = make(port, cfg, native_jpeg=False)[0]
    assert pil["image"].tobytes() == make(
        jax, jcfg, native_jpeg=False)[0]["image"].tobytes()
    Ht, Wt = cfg.model.insize
    assert got["image"].shape == (Ht, Wt, 3)
    for s in (got, pil):
        np.testing.assert_array_equal(s["keypoints"], got["keypoints"])
    first = np.asarray(joints[0], np.float32) * np.asarray(
        [Wt / 1280, Ht / 720], np.float32)
    assert np.isclose(got["keypoints"][0], first, rtol=1e-5).all(
        axis=-1).any()
    diff = np.abs(got["image"] - pil["image"])
    assert 0 < diff.mean() < 0.05 and diff.max() > 10 / 255


# ---- bitwise against the reference ------------------------------------------

@pytest.mark.parametrize("hw,quality", [((720, 1280), 95), ((480, 640), 75),
                                        ((384, 384), 95), ((150, 200), 95)])
def test_decode_resize_bitwise_reference(hw, quality):
    """Downscaled (1280×720, 640×480), identity (384²) and upscaled
    (200×150) sources at two output sizes, noisy smooth images at two
    qualities: the port's pixels are the reference build's, bit for bit."""
    jpeg = _smooth_jpeg(*hw, quality=quality, noise=40)
    for out in ((384, 384), (192, 256)):
        got = nl.decode_resize(jpeg, out)
        assert got.tobytes() == ref.decode_resize(jpeg, out).tobytes(), out
    assert nl.jpeg_dims(jpeg) == ref.jpeg_dims(jpeg) == (hw[1], hw[0])


# ---- no library, no fallback ----------------------------------------------------

def test_missing_pillow_libjpeg_raises_and_names_it(tmp_path, monkeypatch):
    """The directory the loader looks in missing, or holding no ABI-62
    libjpeg; and g++ missing: every entry point raises naming the cause
    and none returns PIL's pixels."""
    jpeg = _smooth_jpeg(48, 64)
    no_abi = tmp_path / "pillow.libs"
    no_abi.mkdir()
    (no_abi / "libjpeg-0000.so.8.2.2").write_bytes(b"")
    cases = [(tmp_path / "missing", "no pillow.libs directory"),
             (no_abi, r"no ABI-62 libjpeg .*libjpeg-0000\.so\.8\.2\.2")]
    for libs, message in cases:
        monkeypatch.setattr(nl, "pillow_libs", lambda libs=libs: libs)
        monkeypatch.setattr(nl, "_lib", None)
        for call in (lambda: nl.decode_resize(jpeg, (32, 32)),
                     lambda: nl.jpeg_dims(jpeg),
                     lambda: nl.NativeJpegLoader((32, 32))):
            with pytest.raises(RuntimeError, match=message):
                call()
        assert not nl.available()
    monkeypatch.undo()
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    monkeypatch.setattr(nl, "LIB", tmp_path / "build" / "libppn_jpeg.so")
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        nl.decode_resize(jpeg, (32, 32))


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Four threads building into an empty directory at once (the suite's
    parallel workers do so from processes): one g++ runs under the lock,
    the others find its library, and the result loads and decodes."""
    import subprocess

    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nl, "LIB", tmp_path / "libppn_jpeg.so")
    runs, real_run = [], subprocess.run

    def counted(cmd, **kw):
        runs.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(nl.subprocess, "run", counted)
    errors = []

    def build():
        try:
            nl._build(nl.libjpeg())
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(runs) == 1 and nl.LIB.is_file()
    import ctypes

    assert ctypes.CDLL(str(nl.LIB)).ppn_decode_resize
    assert [p.name for p in tmp_path.iterdir()
            if p.name.endswith(".tmp")] == []
