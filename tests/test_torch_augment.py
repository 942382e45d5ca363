"""The port's augmentation (ppn_tpu_torch/ops/augment.py) against the JAX
package's TPU batch path (ppn_tpu/ops/augment.py augment_batch, lines
208-234), the path that runs the warp kernel.

Random draws cannot match (jax.random against torch.Generator), so the
parameters are drawn by the JAX package's own _sample_params, vmapped, and
fed to the port's deterministic apply_augment. The JAX side is assembled by
hand as tests/test_pallas_warp.py assembles it, op by op: under jit XLA
moves some of the color suite's bf16 roundings.

Tolerances:
  * Warp stage against the Pallas kernel in interpret mode: the Pallas
    test's limits (max ≤ 5e-3, mean < 1e-6, under 1% of pixels above
    1e-5). The kernel itself is an ulp off the dense warp at a few
    hat-argument boundaries; the port equals the dense warp bitwise
    (tests/test_torch_warp.py), so the whole chain is held against the
    JAX chain built on the dense warp.
  * GT: rtol 1e-5, atol 1e-4 (tests/test_pallas_warp.py's own), visible
    exact.
  * Color stage fed the same warped image: f32 within 1e-6 (the per-image
    means are f32 sums taken in another order); bf16 within one bf16 ulp
    of the value, on under 1% of pixels (such a mean difference can tip a
    rounding at a stage boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.pipeline import collate
from ppn_tpu.data.synthetic import SyntheticPoseDataset
from ppn_tpu.ops import augment as jaug
from ppn_tpu.ops.image import affine_warp_separable
from ppn_tpu.ops.pallas_warp import affine_warp_batch_pallas
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.ops import augment as aug


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, B, augment_dtype, seed=5):
    jcfg, cfg = jax_get_config(name), get_config(name)
    jd = dataclasses.replace(jcfg.data, augment_dtype=augment_dtype)
    td = dataclasses.replace(cfg.data, augment_dtype=augment_dtype)
    ds = SyntheticPoseDataset(jcfg, size=B, seed=seed, num_persons=2)
    batch = collate([ds[i] for i in range(B)], image_uint8=True)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    bwd, fwd, scale, flip, color = jax.jit(jax.vmap(
        lambda k, bx, vl: jaug._sample_params(jcfg.model, jd, k, bx, vl)
    ))(keys, jnp.asarray(batch["bboxes"]), jnp.asarray(batch["valid"]))
    params = aug.AugmentParams(
        bwd=torch.from_numpy(np.array(bwd)),
        fwd=torch.from_numpy(np.array(fwd)),
        scale=torch.from_numpy(np.array(scale)),
        flip=torch.from_numpy(np.array(flip)),
        color=torch.from_numpy(np.stack([np.array(c) for c in color], -1)))
    return jcfg, cfg, jd, td, batch, (bwd, fwd, scale, flip, color), params


def _jax_warp(jd, batch, bwd, pallas=True):
    """uint8 → f32/255 (→ bf16), then the Pallas kernel in interpret mode,
    or the dense warp it replaces, image by image and op by op."""
    img = jnp.asarray(batch["image"]).astype(jnp.float32) / 255.0
    if jd.augment_dtype == "bfloat16":
        img = img.astype(jnp.bfloat16)
    if pallas:
        return affine_warp_batch_pallas(img, bwd, True)
    H, W = img.shape[1:3]
    return jnp.stack([affine_warp_separable(img[i], bwd[i], (H, W))
                      for i in range(img.shape[0])])


def _jax_color(jd, warped, color):
    return jax.vmap(lambda o, b, c, s, sh:
                    jaug._apply_color(jd, o, (b, c, s, sh)))(warped, *color)


def _assert_color_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= 1e-6, d.max()
        return
    # one bf16 ulp of the value: the f32 spacing times 2^16
    bf16_ulp = np.spacing(np.abs(want)) * 2.0 ** 16
    assert (d <= bf16_ulp).all(), (d - bf16_ulp).max()
    assert (d > 0).mean() < 1e-2, (d > 0).mean()


@pytest.mark.parametrize("augment_dtype", ["bfloat16", "float32"])
def test_apply_augment_matches_jax_batch_path(augment_dtype):
    jcfg, cfg, jd, td, batch, (bwd, fwd, scale, flip, color), params = \
        _setup("tiny_test", 2, augment_dtype)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()
          if k != "headsizes"}
    img = tb["image"].float() / 255.0
    if augment_dtype == "bfloat16":
        img = img.to(torch.bfloat16)
    d = np.abs(aug.affine_warp_batch(img, params.bwd).float().numpy()
               - np.asarray(_jax_warp(jd, batch, bwd), np.float32))
    assert d.max() <= 5e-3 and d.mean() < 1e-6, (d.max(), d.mean())
    assert (d > 1e-5).mean() < 1e-2

    want_img = _jax_color(jd, _jax_warp(jd, batch, bwd, pallas=False),
                          color)
    kp, vis, box = jax.vmap(
        lambda f, sc, fl, p, v, bx:
        jaug._transform_gt(jcfg.model, f, sc, fl, p, v, bx)
    )(fwd, scale, flip, batch["keypoints"], batch["visible"],
      batch["bboxes"])

    got = aug.apply_augment(cfg.model, td, params, tb)
    assert got["image"].dtype == {"bfloat16": torch.bfloat16,
                                  "float32": torch.float32}[augment_dtype]
    assert tuple(got["image"].shape) == tuple(want_img.shape)
    _assert_color_close(got["image"], want_img, augment_dtype)
    np.testing.assert_allclose(got["keypoints"].numpy(), np.asarray(kp),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(box),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["visible"].numpy(), np.asarray(vis))
    np.testing.assert_array_equal(got["valid"].numpy(), batch["valid"])


@pytest.mark.parametrize("augment_dtype", ["bfloat16", "float32"])
def test_color_stage_and_gt_match_jax_at_384(augment_dtype):
    """Both color suites on the same warped mpii_r18_384 images (the port's
    warp, which equals the dense JAX warp bitwise), and both GT
    transforms."""
    jcfg, cfg, jd, td, batch, (_, fwd, scale, flip, color), params = \
        _setup("mpii_r18_384", 2, augment_dtype, seed=9)
    img = torch.from_numpy(batch["image"]).float() / 255.0
    if augment_dtype == "bfloat16":
        img = img.to(torch.bfloat16)
    warped = aug.affine_warp_batch(img, params.bwd)
    want = _jax_color(jd, jnp.asarray(warped.float().numpy()).astype(
        jnp.bfloat16 if augment_dtype == "bfloat16" else jnp.float32), color)
    got = aug.apply_color(td, warped, params.color)
    assert got.dtype == warped.dtype
    _assert_color_close(got, want, augment_dtype)

    kp, vis, box = jax.vmap(
        lambda f, sc, fl, p, v, bx:
        jaug._transform_gt(jcfg.model, f, sc, fl, p, v, bx)
    )(fwd, scale, flip, batch["keypoints"], batch["visible"],
      batch["bboxes"])
    got_kp, got_vis, got_box = aug.transform_gt(
        cfg.model, params.fwd, params.scale, params.flip,
        *(torch.from_numpy(batch[k]) for k in
          ("keypoints", "visible", "bboxes")))
    np.testing.assert_allclose(got_kp.numpy(), np.asarray(kp),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(box),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(vis))


def test_sample_params_shapes_and_ranges():
    cfg = get_config("tiny_test")
    d = cfg.data
    ds = SyntheticPoseDataset(jax_get_config("tiny_test"), size=64,
                              seed=3, num_persons=(1, 3))
    batch = collate([ds[i] for i in range(64)])
    bboxes = torch.from_numpy(batch["bboxes"])
    valid = torch.from_numpy(batch["valid"])
    valid[0] = False                       # no person: no crop, no NaN
    gen = torch.Generator().manual_seed(0)
    p = aug.sample_params(cfg.model, d, gen, bboxes, valid)
    B = 64
    assert tuple(p.bwd.shape) == tuple(p.fwd.shape) == (B, 2, 3)
    assert tuple(p.scale.shape) == (B,) and p.flip.dtype == torch.bool
    assert tuple(p.color.shape) == (B, 4)
    for t in p:
        assert torch.isfinite(t.float()).all()
    # bwd inverts fwd
    eye = torch.eye(3).expand(B, 3, 3).clone()
    full = lambda m: torch.cat([m, eye[:, 2:]], dim=1)
    np.testing.assert_allclose((full(p.bwd) @ full(p.fwd)).numpy(),
                               eye.numpy(), atol=1e-4)
    # a crop zooms the jittered scale by a factor clipped to [0.25, 4]
    assert (p.scale >= 0.25 * d.scale_min).all()
    assert (p.scale <= 4.0 * d.scale_max).all()
    # image 0 has no person: plain scale jitter around the center
    assert d.scale_min <= float(p.scale[0]) <= d.scale_max
    for i, j in enumerate((d.color_jitter, d.color_jitter,
                           d.saturation_jitter, d.sharpness_jitter)):
        assert ((p.color[:, i] >= 1 - j) & (p.color[:, i] <= 1 + j)).all()
    # every branch is taken somewhere in 64 draws
    assert 0 < int(p.flip.sum()) < B
    cropped = (p.scale < d.scale_min) | (p.scale > d.scale_max)
    assert 0 < int(cropped.sum()) < B
    # the same generator state draws the same parameters
    q = aug.sample_params(cfg.model, d, torch.Generator().manual_seed(0),
                          bboxes, valid)
    for a, b in zip(p, q):
        assert torch.equal(a, b)
