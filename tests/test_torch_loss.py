"""The port's PPN loss (ppn_tpu_torch/train/loss.py) against the JAX
package's ppn_loss, in f32, on random feature maps and encoded targets.

The JAX terms come from its loss jitted alone, the gradient from its jitted
grad. XLA on the CPU sums the 5.6e5 limb terms of an mpii_r18_384 batch of
3 ("all" mode) sequentially op by op, and also under value_and_grad: 1.2e-4
away from a float64 evaluation. The loss jitted alone is within 1e-6 of
it, as the port's sum is.

Tolerances: each term within rel 1e-5 (sums over up to ~6e5 terms taken in
another order), the gradient with respect to the feature map within 1e-5
of its largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import random_people
from ppn_tpu.ops import encode as jenc
from ppn_tpu.train.loss import limb_mask as jax_limb_mask
from ppn_tpu.train.loss import ppn_loss as jax_ppn_loss
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.ops.encode import TargetGrids
from ppn_tpu_torch.train.loss import limb_mask, ppn_loss


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GT = ("keypoints", "visible", "bboxes", "valid")


def _case(name, mode, B=3, seed=0):
    jm = dataclasses.replace(jax_get_config(name).model, limb_loss_mode=mode)
    m = dataclasses.replace(get_config(name).model, limb_loss_mode=mode)
    scenes = [random_people(np.random.default_rng(seed + i), jm,
                            jax_get_config(name).data.max_persons, None)
              for i in range(B)]
    jt = jax.jit(jenc.encode_batch, static_argnums=0)(
        jm, *(np.stack([s[k] for s in scenes]) for k in GT))
    t = TargetGrids(*(torch.from_numpy(np.array(g)) for g in jt))
    fm = np.random.default_rng(seed + 100).normal(
        0, 1.5, (B, *m.outsize, m.num_channels)).astype(np.float32)
    return jm, m, jt, t, fm


@pytest.mark.parametrize("name,mode", [("tiny_test", "paired"),
                                       ("mpii_r18_384", "paired"),
                                       ("mpii_r18_384", "all")])
def test_terms_and_gradient_match_jax(name, mode):
    jm, m, jt, t, fm = _case(name, mode)

    _, want = jax.jit(lambda x: jax_ppn_loss(jm, x, jt))(jnp.asarray(fm))
    jgrad = jax.jit(jax.grad(lambda x: jax_ppn_loss(jm, x, jt)[0]))(
        jnp.asarray(fm))
    x = torch.from_numpy(fm).requires_grad_(True)
    total, got = ppn_loss(m, x, t)
    total.backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    jgrad = np.asarray(jgrad)
    assert np.abs(x.grad.numpy() - jgrad).max() <= 1e-5 * np.abs(jgrad).max()


def test_limb_mask_matches_jax():
    jm, m, jt, t, _ = _case("mpii_r18_384", "paired", B=2, seed=4)
    want = np.asarray(jax.jit(lambda d: jax_limb_mask(jm, d))(jt.delta))
    got = limb_mask(m, t.delta).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_iou_target_is_a_label():
    """The IoU confidence target carries no gradient: the iou term reaches
    the conf channels only (tests/test_loss.py's check)."""
    _, m, _, t, _ = _case("tiny_test", "paired", B=2, seed=5)
    x = torch.zeros((2, *m.outsize, m.num_channels), requires_grad=True)
    _, terms = ppn_loss(m, x, t)
    terms["loss_iou"].backward()
    K1 = m.num_classes
    g = x.grad.numpy()
    assert np.abs(g[..., K1:2 * K1]).sum() > 0
    assert np.abs(g[..., 2 * K1:6 * K1]).sum() == 0
