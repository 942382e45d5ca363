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
from ppn_tpu_torch.testing import (EDGE_KINDS, KINDS, feature_map_case,
                                   max_ulp, nan_window_case)

from test_postprocess import oracle_nms, oracle_parse
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ULPS = 4
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
CONFIGS = ["tiny_test", "mpii_r18_384", "coco_r18_384_crowded",
           "mpii_r18_224_fast"]


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


@pytest.mark.parametrize("name", ["mpii_r18_384", "coco_r18_384_crowded"])
def test_edge_case_maps(name):
    """The kernel's edge-case maps are what they claim: ``empty`` keeps
    nothing; ``chain`` puts every proposal above the threshold and greedy NMS
    keeps every other cell of each row."""
    m = get_config(name).model
    H, W = m.outsize
    for kind in EDGE_KINDS:
        fm = torch.from_numpy(feature_map_case(m, 2, 3, kind))
        _, props = dec.decode(m, fm)
        keep = nmsops.nms_batch(m, props).keep
        if kind == "empty":
            assert not keep.any()
        else:
            assert bool((props.score > m.detection_thresh).all())
            alternate = torch.arange(W) % 2 == 0
            assert torch.equal(keep, alternate[None, None, :, None].expand(
                keep.shape))


def test_needed_bytes_hand_count():
    """``cuda_post.needed_bytes`` on tiny_test maps counted by hand. The
    grid is 2×2 and the window 3×3, so from each of the 4 cells every cell
    is exactly one window offset away."""
    m = get_config("tiny_test").model
    K1 = m.num_classes
    fm = feature_map_case(m, 2, 0, "empty")   # image 1 keeps nothing
    fm[..., 4 * K1:6 * K1] = -5.0             # sub-pixel boxes: no overlaps
    fm[0, 0, 0, [2, K1 + 2]] = 20.0           # class 2 kept at cell (0, 0)
    fm[0, 0, 0, [5, K1 + 5]] = 20.0           # class 5 kept at (0, 0) and
    fm[0, 1, 1, [5, K1 + 5]] = 20.0           # (1, 1)
    # per image: 4 cells × 6·17 proposal channels × 4 B = 1632 B, and
    # People: 4 slots × 17 × (8 + 16 + 4 + 1) B + 4 × (1 + 4) B = 1992 B;
    # limb reads of image 0: limb 3→2 from 4 cells × 1 kept destination,
    # limb 4→5 from 4 cells × 2 kept destinations, 4 B each; no instance is
    # kept, so the walk consults no row
    assert [d for _, d in m.edges].count(2) == 1
    assert [d for _, d in m.edges].count(5) == 1
    want = 2 * (1632 + 1992) + 4 * (4 * 1 + 4 * 2)
    assert cuda_post.needed_bytes(m, torch.from_numpy(fm)) == want
    # the NaN window case: limb 0→3 keeps (0, 1) and (1, 1), 2 logits from
    # each of the 4 cells; the walk consults the row from (0, 0), so its
    # other 2 in-frame logits count too (to find the NaN); below it the walk
    # stops. Without the NaN the row wins and the walk goes on from (1, 1),
    # but no limb from class 3 has a kept destination: the same count.
    fm = nan_window_case(m)
    want = 1632 + 1992 + 4 * (4 * 2 + 2)
    assert cuda_post.needed_bytes(m, torch.from_numpy(fm)) == want
    fm[np.isnan(fm)] = -3.0
    assert cuda_post.needed_bytes(m, torch.from_numpy(fm)) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_plain_matches_jax_on_nan_window_case(name):
    """One NaN limb logit beside the winner its window would otherwise have
    (ROADMAP queue 3): the row has no winner, in the port as in JAX."""
    m, jm = get_config(name).model, jax_get_config(name).model
    fm = nan_window_case(m)
    want = jax.device_get(jpost.postprocess_batch(jm, fm))
    got = postprocess_batch_plain(m, torch.from_numpy(fm))
    _assert_people_match(got, want, (name, "nan window"))
    d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
    assert got.kp_cell[0, 0, d].tolist() == [0, 0]
    assert float(got.kp_score[0, 0, d]) == 0.0
    fm[np.isnan(fm)] = -3.0                   # without the NaN, (1, 1) wins
    clean = postprocess_batch_plain(m, torch.from_numpy(fm))
    assert clean.kp_cell[0, 0, d].tolist() == [1, 1]
    assert float(clean.kp_score[0, 0, d]) > 0.9


def test_stage_us_reads_the_stamps():
    stamps = torch.tensor([[0, 1000, 3000, 3000, 7000, 8000, 8500, 9500],
                           [0, 3000, 4000, 5000, 7000, 9000, 9500, 10500]])
    us = cuda_post.stage_us(stamps)
    assert list(us) == list(cuda_post.STAGES)
    assert list(us.values()) == [2.0, 1.5, 0.5, 3.0, 1.5, 0.5, 1.0]
