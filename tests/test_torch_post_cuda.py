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
from ppn_tpu_torch.testing import KINDS, feature_map_case, max_ulp

pytestmark = pytest.mark.cuda

ULPS = 4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384",
                                  "coco_r18_384_crowded"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(device, name, kind):
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    m = get_config(name).model
    for seed in range(4):
        fm = torch.from_numpy(feature_map_case(m, 3, seed, kind)).to(device)
        before = cuda_post.LAUNCHES
        got = cuda_post.postprocess_batch_cuda(m, fm)
        torch.cuda.synchronize()
        assert cuda_post.LAUNCHES == before + 1
        want = postprocess_batch_plain(m, fm)
        for f in ("kp_cell", "kp_valid", "valid", "num_kp"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and torch.equal(g, w), (f, seed)
        for f in ("kp_box", "kp_score"):
            ulp = max_ulp(getattr(got, f).cpu().numpy(),
                          getattr(want, f).cpu().numpy())
            assert ulp <= ULPS, (f, seed, ulp)


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
