"""The port's affine warp (ppn_tpu_torch/ops/image.py
affine_warp_separable_plain, and ppn_warp_kernel on the card) against the
JAX package's affine_warp_separable and its Pallas kernel.

The kernel itself is held against the plain version on the card by
tests/test_torch_warp_cuda.py, which imports no JAX.

The same images (the JAX package's synthetic renders) and the same
matrices (its make_affine) go through both sides. Limits are the Pallas
test's own (tests/test_pallas_warp.py): max ≤ 5e-3 (one bf16 ulp at 1),
mean < 1e-6, and under 1% of pixels off by more than 1e-5. The port's
plain version computes the same taps, weights and roundings as the dense
JAX warp, so it is expected to be bitwise equal; the limits leave room for
an ulp of hat-argument rounding, as the Pallas kernel needs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import SyntheticPoseDataset
from ppn_tpu.ops.image import affine_warp_separable
from ppn_tpu.ops.image import make_affine as jax_make_affine
from ppn_tpu.ops.pallas_warp import affine_warp_batch_pallas
from ppn_tpu_torch.ops import cuda_warp
from ppn_tpu_torch.ops.image import (affine_warp_separable_plain,
                                     apply_affine_points, make_affine)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (angle, scale, tx, flip), tests/test_pallas_warp.py CASES
CASES = [
    (0.0, 1.0, 0.0, False),      # identity
    (0.3, 1.1, 12.0, False),     # mild rotate + zoom-in + translate
    (-0.5, 0.8, -7.0, False),    # rotate the other way + zoom-out
    (0.7, 1.25, 3.0, True),      # heavy rotate + flip (negative r path)
    (0.69, 3.9, 50.0, False),    # near the max zoom clip
    (-0.69, 0.26, -120.0, True), # near max zoom-out + large shift + flip
]


@functools.lru_cache(maxsize=None)
def _renders(name):
    cfg = jax_get_config(name)
    return np.stack([SyntheticPoseDataset(cfg, size=1, seed=21 + i,
                                          num_persons=1)[0]["image"]
                     for i in range(2)]).astype(np.float32)


def _images(name, n=2):
    return _renders(name)[:n].copy()


def _matrix(H, W, case):
    angle, scale, tx, flip = case
    center = jnp.asarray([W / 2, H / 2], jnp.float32)
    bwd, fwd = jax_make_affine(center, center, jnp.float32(angle),
                               jnp.float32(scale),
                               jnp.asarray([tx, -tx], jnp.float32), flip)
    return np.array(bwd), np.array(fwd)


def _check(got, want):
    d = np.abs(got - want)
    assert d.max() <= 5e-3, d.max()
    assert d.mean() < 1e-6, d.mean()
    assert (d > 1e-5).mean() < 1e-2
    return int((d > 0).sum())


@pytest.mark.parametrize("name", ["mpii_r18_384", "tiny_test"])
@pytest.mark.parametrize("pair", [(0, 1), (2, 3), (4, 5)])
def test_plain_warp_matches_jax_separable(name, pair):
    """Two images in one batch, each with its own matrix from CASES,
    against the JAX warp of each image alone. The JAX warp runs op by op,
    as tests/test_pallas_warp.py runs it: under jit, XLA on the CPU
    contracts r·x + t into an FMA, which moves hat arguments by an ulp
    (case 4 then differs on a mean of 1.5e-6 per pixel)."""
    imgs = _images(name)
    H, W = imgs.shape[1:3]
    mats = np.stack([_matrix(H, W, CASES[i])[0] for i in pair])
    got = affine_warp_separable_plain(torch.from_numpy(imgs),
                                      torch.from_numpy(mats)).numpy()
    for j in range(2):
        want = np.asarray(affine_warp_separable(
            jnp.asarray(imgs[j]), jnp.asarray(mats[j]), (H, W)))
        differing = _check(got[j], want)
        print(f"{name} case {pair[j]}: {differing} pixels differ from JAX")


def test_plain_warp_matches_pallas_interpret():
    imgs = _images("tiny_test", 1)
    H, W = imgs.shape[1:3]
    mats = _matrix(H, W, CASES[3])[0][None]
    want = np.asarray(affine_warp_batch_pallas(
        jnp.asarray(imgs), jnp.asarray(mats), True))
    got = affine_warp_separable_plain(torch.from_numpy(imgs),
                                      torch.from_numpy(mats)).numpy()
    _check(got, want)


@pytest.mark.parametrize("i", range(4))
def test_bf16_io_equals_rounded_f32(i):
    """Pixels meet the weights as bf16 either way, so the bf16 warp is
    exactly the f32 warp of the bf16 image, rounded once."""
    imgs = torch.from_numpy(_images("mpii_r18_384", 1))
    H, W = imgs.shape[1:3]
    mats = torch.from_numpy(_matrix(H, W, CASES[i])[0][None])
    img16 = imgs.to(torch.bfloat16)
    got = affine_warp_separable_plain(img16, mats)
    assert got.dtype == torch.bfloat16
    want = affine_warp_separable_plain(img16.float(), mats)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_make_affine_matches_jax():
    H = W = 384.0
    for case in CASES:
        bwd, fwd = _matrix(H, W, case)
        angle, scale, tx, flip = case
        c = torch.tensor([W / 2, H / 2])
        tb, tf = make_affine(c, c, torch.tensor(angle), torch.tensor(scale),
                             torch.tensor([tx, -tx]), flip)
        np.testing.assert_allclose(tb.numpy(), bwd, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(tf.numpy(), fwd, rtol=1e-6, atol=1e-5)
        pts = np.array([[10.0, 20.0], [300.0, 5.0]], np.float32)
        got = apply_affine_points(tf[None], torch.from_numpy(pts)[None])[0]
        want = fwd[:, :2] @ pts.T + fwd[:, 2:]
        np.testing.assert_allclose(got.numpy(), want.T, rtol=1e-5,
                                   atol=1e-3)


def test_wrapper_dispatch_without_fallback():
    imgs = torch.from_numpy(_images("tiny_test", 1))
    mats = torch.from_numpy(_matrix(64, 64, CASES[1])[0][None])
    before = cuda_warp.LAUNCHES
    assert torch.equal(cuda_warp.affine_warp_batch(imgs, mats),
                       affine_warp_separable_plain(imgs, mats))
    assert cuda_warp.LAUNCHES == before   # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        cuda_warp.affine_warp_cuda(imgs, mats)
    with pytest.raises(ValueError, match="device"):
        cuda_warp.affine_warp_batch(imgs.to("meta"), mats.to("meta"))
    with pytest.raises(TypeError):
        affine_warp_separable_plain(imgs.double(), mats)
