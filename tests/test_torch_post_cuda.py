"""ppn_post_kernel (CUDA) against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc; without one every test here skips. Run on
the card with ``python -m pytest --noconftest tests/test_torch_post_cuda.py``
(the repo's conftest imports JAX, which the GPU machine does not need).

Decision fields must be bitwise equal. Float fields (kp_box, kp_score) must
be within 4 ulps: both sides evaluate the same formulas in f32 without FMA
contraction, so 0 is expected, and 4 leaves room for a different expf
rounding between the kernel and PyTorch's exp.
"""

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.testing import (KINDS, feature_map_case, max_ulp,
                                   nan_window_case)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.cuda,
              pytest.mark.usefixtures("one_torch_thread")]

ULPS = 4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_kernel_matches_plain(m, fm, ctx):
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    before = cuda_post.LAUNCHES
    got = cuda_post.postprocess_batch_cuda(m, fm)
    torch.cuda.synchronize()
    assert cuda_post.LAUNCHES == before + 1
    want = postprocess_batch_plain(m, fm)
    for f in ("kp_cell", "kp_valid", "valid", "num_kp"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), (ctx, f)
    for f in ("kp_box", "kp_score"):
        ulp = max_ulp(getattr(got, f).cpu().numpy(),
                      getattr(want, f).cpu().numpy())
        assert ulp <= ULPS, (ctx, f, ulp)


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384",
                                  "coco_r18_384_crowded"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(device, name, kind):
    m = get_config(name).model
    for seed in range(4):
        fm = torch.from_numpy(feature_map_case(m, 3, seed, kind)).to(device)
        _assert_kernel_matches_plain(m, fm, seed)


@pytest.mark.parametrize("name, batch, kind", [
    ("mpii_r18_384", 4, "empty"),            # no candidate in any class
    ("mpii_r18_384", 4, "chain"),            # every proposal a candidate,
    ("coco_r18_384_crowded", 4, "chain"),    # keeps alternating
    ("mpii_r18_384", 133, "normal"),         # more CTAs than SMs
    ("mpii_r18_384", 128, "nan"),            # NaN logits at full batch
    ("coco_r18_384_crowded", 128, "nan"),
])
def test_kernel_matches_plain_on_edge_cases(device, name, batch, kind):
    m = get_config(name).model
    for seed in range(2):
        fm = feature_map_case(m, batch, seed, kind)
        _assert_kernel_matches_plain(m, torch.from_numpy(fm).to(device), seed)


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384",
                                  "coco_r18_384_crowded"])
def test_kernel_matches_plain_on_nan_window_case(device, name):
    """One NaN limb logit beside the winner its window would otherwise
    have: no winner in that row, in the kernel as in the plain version."""
    m = get_config(name).model
    fm = torch.from_numpy(nan_window_case(m)).to(device)
    _assert_kernel_matches_plain(m, fm, name)
    from ppn_tpu_torch.ops import cuda_post

    got = cuda_post.postprocess_batch_cuda(m, fm)
    d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
    assert got.kp_cell[0, 0, d].tolist() == [0, 0]
    assert float(got.kp_score[0, 0, d]) == 0.0


def test_stage_clocks(device):
    """The stage stamps rise through the stages and timing changes no
    output."""
    from ppn_tpu_torch.ops import cuda_post

    m = get_config("mpii_r18_384").model
    fm = torch.from_numpy(feature_map_case(m, 5, 1)).to(device)
    clocks = torch.zeros((5, len(cuda_post.STAGES) + 1), dtype=torch.int64,
                         device=device)
    timed = cuda_post.postprocess_batch_cuda(m, fm, stage_clocks=clocks)
    plain = cuda_post.postprocess_batch_cuda(m, fm)
    torch.cuda.synchronize()
    assert bool((clocks.diff(dim=1) >= 0).all()) and bool(clocks[:, 0].gt(0).all())
    assert all(torch.equal(a, b) for a, b in zip(timed, plain))
    assert set(cuda_post.stage_us(clocks)) == set(cuda_post.STAGES)


def test_fast_path_launches_kernel(device):
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_fast

    m = get_config("mpii_r18_384").model
    fm = torch.from_numpy(feature_map_case(m, 2, 0)).to(device)
    before = cuda_post.LAUNCHES
    ppl = postprocess_batch_fast(m, fm)
    assert cuda_post.LAUNCHES == before + 1
    assert np.isfinite(ppl.kp_box.cpu().numpy()).all()


def test_kernel_rejects_bad_input(device):
    from ppn_tpu_torch.ops import cuda_post

    m = get_config("tiny_test").model
    fm = torch.zeros((1, *m.outsize, m.num_channels), device=device)
    with pytest.raises(TypeError):
        cuda_post.postprocess_batch_cuda(m, fm.double())
    with pytest.raises(ValueError):
        cuda_post.postprocess_batch_cuda(m, fm[..., :-1])
    with pytest.raises(ValueError):
        cuda_post.postprocess_batch_cuda(m, fm.transpose(1, 2))
