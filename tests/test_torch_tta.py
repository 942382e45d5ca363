"""The port's flip-TTA (ppn_tpu_torch/ops/tta.py), its bilinear resize, the
TTA forward and the TTA predict, against the JAX package on the CPU.

Tolerances: the permutations, the map flip and the mirror move values
without arithmetic, so they are exact; the merge rounds once (the sum, then
an exact halving) and is held within 1 ulp; the resize within 1e-6 (the two
frameworks sum the antialiasing taps in other orders; measured ≤ 2.4e-7).
The TTA forward in f32 is held within 2e-5 of the largest logit, as
tests/test_torch_model.py holds the plain forward; the TTA predict's
decision fields are bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import SyntheticPoseDataset
from ppn_tpu.inference import Predictor as JaxPredictor
from ppn_tpu.nn.model import PoseProposalNet as JaxPPN
from ppn_tpu.ops import tta as jtta
from ppn_tpu.train import steps as jst
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.ops import encode as enc
from ppn_tpu_torch.ops import tta
from ppn_tpu_torch.ops.image import resize_bilinear
from ppn_tpu_torch.testing import max_ulp
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.utils.params_io import state_dict_from_jax_leaves

from test_torch_model import _jax_template, _numpy_leaves
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = ["tiny_test", "mpii_r18_384", "coco_r18_384_crowded",
           "mpii_r18_224_fast"]
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
F32_TOL = 2e-5


def _map(cfg, seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, *cfg.outsize, cfg.num_channels)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_permutations_match_jax_and_are_involutions(name):
    m, jm = get_config(name).model, jax_get_config(name).model
    cp, ep = tta.class_permutation(m), tta.edge_permutation(m)
    np.testing.assert_array_equal(cp, jtta.class_permutation(jm))
    np.testing.assert_array_equal(ep, jtta.edge_permutation(jm))
    assert cp[0] == 0
    np.testing.assert_array_equal(cp[cp], np.arange(m.num_classes))
    np.testing.assert_array_equal(ep[ep], np.arange(m.num_limbs))
    if name == "mpii_r18_384":
        # instance→thorax mirrors to itself; thorax→r_shoulder ↔ l_shoulder
        edges = list(m.edges)
        assert ep[edges.index((0, 3))] == edges.index((0, 3))
        assert ep[edges.index((3, 4))] == edges.index((3, 7))


@pytest.mark.parametrize("name", CONFIGS)
def test_flip_feature_map_matches_jax_and_is_involution(name):
    m, jm = get_config(name).model, jax_get_config(name).model
    fm = _map(m, 0)
    got = tta.flip_feature_map(m, torch.from_numpy(fm))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtta.flip_feature_map(jm, jnp.asarray(fm))))
    np.testing.assert_array_equal(tta.flip_feature_map(m, got).numpy(), fm)


@pytest.mark.parametrize("name", CONFIGS)
def test_merge_flip_tta_matches_jax(name):
    m, jm = get_config(name).model, jax_get_config(name).model
    a, b = _map(m, 1), _map(m, 2)
    got = tta.merge_flip_tta(m, torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jtta.merge_flip_tta(jm, jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32
    assert max_ulp(got.numpy(), want) <= 1
    # a map merged with its own mirror image is itself
    same = tta.merge_flip_tta(m, torch.from_numpy(a),
                              tta.flip_feature_map(m, torch.from_numpy(a)))
    np.testing.assert_allclose(same.numpy(), a, rtol=0, atol=1e-6)


def test_flip_feature_map_matches_mirrored_encode():
    """A map encoded from mirrored ground truth, mapped back, is the map
    encoded from the original (resp/conf and limbs everywhere, offsets and
    sizes at responsible cells): the mirror algebra is exact."""
    cfg = get_config("mpii_r18_384")
    m = cfg.model
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset as Synth

    s = Synth(cfg, size=1, seed=3, num_persons=2)[0]
    W = m.insize[1]
    perm = tta.class_permutation(m)[1:] - 1
    kp_f = s["keypoints"].copy()
    kp_f[..., 0] = W - kp_f[..., 0]
    boxes_f = s["bboxes"].copy()
    boxes_f[..., 0] = W - boxes_f[..., 0]

    def fmap(kp, vis, boxes):
        t = enc.encode_batch(m, *(torch.from_numpy(np.asarray(v))[None]
                                  for v in (kp, vis, boxes, s["valid"])))
        return enc.targets_to_feature_map(m, t)

    fm = fmap(s["keypoints"], s["visible"], s["bboxes"]).numpy()
    back = tta.flip_feature_map(m, fmap(kp_f[:, perm], s["visible"][:, perm],
                                        boxes_f)).numpy()
    K1 = m.num_classes
    np.testing.assert_allclose(back[..., :2 * K1], fm[..., :2 * K1],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(back[..., 6 * K1:], fm[..., 6 * K1:],
                               rtol=0, atol=1e-4)
    resp = fm[..., :K1] > 0
    for g in range(2, 6):
        grp = slice(g * K1, (g + 1) * K1)
        np.testing.assert_allclose(back[..., grp][resp], fm[..., grp][resp],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_mirror_images_matches_jax_and_is_involution(dtype):
    rng = np.random.default_rng(4)
    x = (rng.random((2, 4, 6, 3)) * 255).astype(dtype)
    m = tta.mirror_images(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(m, np.asarray(jtta.mirror_images(x)))
    # index u → W − u (the augmentation flip's convention), not W − 1 − u
    np.testing.assert_array_equal(m[:, :, 1], x[:, :, 5])
    np.testing.assert_array_equal(m[:, :, 5], x[:, :, 1])
    np.testing.assert_array_equal(
        tta.mirror_images(torch.from_numpy(m)).numpy(), x)


@pytest.mark.parametrize("src, dst", [((720, 1280), (384, 384)),
                                      ((120, 160), (64, 64)),
                                      ((720, 1280), (224, 224))])
def test_resize_bilinear_matches_jax(src, dst):
    """jax.image.resize's bilinear antialiases when it downscales."""
    frame = np.random.default_rng(5).integers(0, 256, (*src, 3), np.uint8)
    img = frame.astype(np.float32) / 255.0
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*dst, 3),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(img), dst).numpy()
    assert got.shape == (*dst, 3)
    assert np.abs(got - want).max() <= 1e-6


@pytest.fixture(scope="module")
def weights():
    """tiny_test in f32 with detection threshold 0.02, and one set of
    seeded weights (tests/test_torch_model.py's) in both packages: the JAX
    model's (graphdef, params, rest) and the port's model, loaded through
    ``utils/params_io``. Seed 5 is one whose TTA predict keeps a person on
    these two images (seeds 1–11 tried), so the decisions compared include
    the limb walk and the person filter."""
    jcfg, cfg = jax_get_config("tiny_test"), get_config("tiny_test")
    jcfg, cfg = (dataclasses.replace(
        c, train=dataclasses.replace(c.train, dtype="float32",
                                     ema_decay=0.0),
        model=dataclasses.replace(c.model, detection_thresh=0.02))
        for c in (jcfg, cfg))
    _, flat, treedef = _jax_template(jcfg.model, jnp.float32)
    leaves = _numpy_leaves(flat, seed=5)
    tree = jax.tree.unflatten(treedef, leaves)
    # the JAX Predictor merges without calling eval(): the graphdef must
    # carry eval mode (running BatchNorm statistics)
    abstract = nnx.eval_shape(
        lambda: JaxPPN(jcfg.model, dtype=jnp.float32, rngs=nnx.Rngs(0)))
    abstract.eval()
    graphdef = nnx.split(abstract, nnx.Param, ...)[0]
    state = st.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax_leaves(cfg, leaves, state.model))
    ds = SyntheticPoseDataset(jcfg, size=2, seed=6, num_persons=2)
    images = np.stack([np.clip(ds[i]["image"] * 255 + 0.5, 0, 255)
                       .astype(np.uint8) for i in range(2)])
    return jcfg, cfg, (graphdef, tree["params"], tree["rest"]), state, images


def test_tta_forward_matches_jax(weights):
    jcfg, cfg, (graphdef, params, rest), state, images = weights
    jstate = jst.TrainState(params=params, rest=rest, opt_state=None, step=0,
                            rng=jax.random.PRNGKey(0))
    want = np.asarray(jst.make_forward(jcfg, graphdef, flip_tta=True)(
        jstate, images))
    fwd = st.make_forward(state, flip_tta=True)
    got = fwd(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    # TTA carries no left/right bias: f(mirror(x)) == flip(f(x))
    got_m = fwd(tta.mirror_images(torch.from_numpy(images)))
    np.testing.assert_allclose(tta.flip_feature_map(cfg.model, got_m).numpy(),
                               got, rtol=0, atol=2e-5)


def test_tta_predict_matches_jax(weights):
    jcfg, cfg, jax_model, state, images = weights
    want = jax.device_get(JaxPredictor(jcfg, *jax_model,
                                       flip_tta=True).predict(images))
    pred = Predictor(cfg, st.eval_model(state), device="cpu", flip_tta=True)
    got = pred.predict(images)
    assert got.valid.any()
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    for f in ("kp_box", "kp_score"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-3)
    # TTA changes the map: the plain predict differs
    pred.flip_tta = False
    assert not np.array_equal(pred.predict(images).kp_score, got.kp_score)
