"""The port's plain post-process against the JAX package's
``postprocess_batch_fn`` (the XLA reference) and the CPU oracles of
tests/test_postprocess.py.

Decision fields (kp_cell, kp_valid, valid, num_kp) must be bitwise equal.
Float fields (kp_box, kp_score) must be within 4 ulps: both sides evaluate
the same f32 formulas in the same order, but σ goes through each framework's
own exp, and PyTorch's CPU exp and XLA's differ by up to 1 ulp (measured),
which σ and the score product carry to at most a few ulps.
"""

import jax
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import random_people
from ppn_tpu.ops import encode as enc
from ppn_tpu.ops import postprocess as jpost
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.ops import cuda_post
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops import nms as nmsops
from ppn_tpu_torch.ops import parse as parseops
from ppn_tpu_torch.ops.postprocess import (postprocess_batch_fast,
                                           postprocess_batch_plain)
from ppn_tpu_torch.testing import KINDS, feature_map_case, max_ulp

from test_postprocess import oracle_nms, oracle_parse

ULPS = 4
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
CONFIGS = ["tiny_test", "mpii_r18_384", "coco_r18_384_crowded"]


def _assert_people_match(got, want, ctx):
    for f in DECISIONS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (ctx, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {f}")
    for f in FLOATS:
        ulp = max_ulp(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert ulp <= ULPS, (ctx, f, ulp)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(name, kind):
    m, jm = get_config(name).model, jax_get_config(name).model
    for seed in range(4):
        fm = feature_map_case(m, 3, seed, kind)
        want = jax.device_get(jpost.postprocess_batch(jm, fm))
        got = postprocess_batch_plain(m, torch.from_numpy(fm))
        _assert_people_match(got, want, (name, kind, seed))


@pytest.mark.parametrize("name", CONFIGS)
def test_plain_matches_jax_on_oracle_scene(name):
    """Oracle-perfect maps of synthetic GT (the scenes of
    tests/test_postprocess.py): sparse, exact, mostly saturated logits."""
    m, jm = get_config(name).model, jax_get_config(name).model
    fms = []
    for seed, persons in ((4, 2), (5, 3), (6, 1)):
        s = random_people(np.random.default_rng(seed), jm, max_persons=3,
                          num_persons=persons)
        t = enc.encode_single(jm, s["keypoints"], s["visible"], s["bboxes"],
                              s["valid"])
        fms.append(np.asarray(enc.targets_to_feature_map(jm, t), np.float32))
    fm = np.stack(fms)
    want = jax.device_get(jpost.postprocess_batch(jm, fm))
    got = postprocess_batch_plain(m, torch.from_numpy(fm))
    _assert_people_match(got, want, (name, "oracle scene"))
    assert got.valid.any()


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384"])
def test_nms_matches_oracle(name):
    m = get_config(name).model
    for seed in range(3):
        fm = torch.from_numpy(feature_map_case(m, 1, seed)[0])
        _, props = dec.decode(m, fm)
        got = nmsops.nms_single(m, props).keep.numpy()
        boxes, score = props.boxes.numpy(), props.score.numpy()
        for c in range(m.num_classes):
            want = oracle_nms(boxes[..., c, :].reshape(-1, 4),
                              score[..., c].reshape(-1),
                              m.detection_thresh, m.nms_thresh)
            np.testing.assert_array_equal(got[..., c].reshape(-1), want,
                                          err_msg=f"class {c} seed {seed}")


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384"])
def test_parse_matches_oracle(name):
    m = get_config(name).model
    for seed in range(3):
        fm = torch.from_numpy(feature_map_case(m, 1, seed)[0])
        act, props = dec.decode(m, fm)
        nms = nmsops.nms_single(m, props)
        got = parseops.parse_single(m, act, props, nms)
        want = oracle_parse(m, act.e.numpy(), nms.score.numpy(),
                            props.boxes.numpy())
        for p, kp in enumerate(want):
            if kp is None:
                assert not bool(got.kp_valid[p, 0]), p
                continue
            person_ok = 0 in kp and len(kp) - 1 >= m.min_num_keypoints
            assert bool(got.valid[p]) == bool(person_ok), p
            if not person_ok:
                continue
            assert int(got.num_kp[p]) == len(kp) - 1
            for c, (yy, xx, sc) in kp.items():
                assert bool(got.kp_valid[p, c]), (p, c)
                assert tuple(got.kp_cell[p, c].tolist()) == (yy, xx)
                assert float(got.kp_score[p, c]) == sc


def test_single_matches_batch():
    m = get_config("mpii_r18_384").model
    fm = torch.from_numpy(feature_map_case(m, 2, 7, "sparse"))
    batch = postprocess_batch_plain(m, fm)
    for i in range(2):
        act, props = dec.decode(m, fm[i])
        nms = nmsops.nms_single(m, props)
        one = parseops.parse_single(m, act, props, nms)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b)


def test_fast_path_on_cpu_is_plain_without_kernel():
    m = get_config("tiny_test").model
    fm = torch.from_numpy(feature_map_case(m, 2, 3))
    before = cuda_post.LAUNCHES
    fast = postprocess_batch_fast(m, fm)
    assert cuda_post.LAUNCHES == before
    for a, b in zip(fast, postprocess_batch_plain(m, fm)):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensor():
    """No silent fallback: the CUDA wrapper raises on a CPU tensor."""
    m = get_config("tiny_test").model
    fm = torch.from_numpy(feature_map_case(m, 1, 0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_post.postprocess_batch_cuda(m, fm)
