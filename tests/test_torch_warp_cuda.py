"""ppn_warp_kernel (CUDA) against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc; without one every test here skips. Run on
the card with ``python -m pytest --noconftest tests/test_torch_warp_cuda.py``
(the repo's conftest imports JAX, which the GPU machine does not need).

Bitwise: every product in the warp is of two bf16 values, exact in f32, and
at most two are non-zero in each sum, so each sum rounds once in any order;
the kernel is built without FMA contraction, as PyTorch's separate
elementwise kernels round.
"""

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.ops import cuda_warp
from ppn_tpu_torch.ops.image import affine_warp_separable_plain, make_affine

pytestmark = pytest.mark.cuda

# (angle, scale, tx, flip), tests/test_pallas_warp.py CASES
CASES = [(0.0, 1.0, 0.0, False), (0.3, 1.1, 12.0, False),
         (-0.5, 0.8, -7.0, False), (0.7, 1.25, 3.0, True),
         (0.69, 3.9, 50.0, False), (-0.69, 0.26, -120.0, True)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(name, device):
    cfg = get_config(name)
    H, W = cfg.model.insize
    ds = SyntheticPoseDataset(cfg, size=len(CASES), seed=21)
    imgs = np.stack([ds[i]["image"] for i in range(len(CASES))])
    c = torch.tensor([W / 2.0, H / 2.0])
    a, s, t, f = zip(*CASES)
    bwd, _ = make_affine(c, c, torch.tensor(a), torch.tensor(s),
                         torch.tensor([[x, -x] for x in t]), torch.tensor(f))
    return torch.from_numpy(imgs).to(device), bwd.to(device)


@pytest.mark.parametrize("name", ["mpii_r18_384", "tiny_test"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(device, name, dtype):
    imgs, mats = _inputs(name, device)
    x = imgs.to(dtype)
    before = cuda_warp.LAUNCHES
    got = cuda_warp.affine_warp_batch(x, mats)
    torch.cuda.synchronize()
    assert cuda_warp.LAUNCHES == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, affine_warp_separable_plain(x, mats))


def test_kernel_rejects_bad_input(device):
    imgs, mats = _inputs("tiny_test", device)
    with pytest.raises(TypeError):
        cuda_warp.affine_warp_cuda(imgs.double(), mats)
    with pytest.raises(ValueError):
        cuda_warp.affine_warp_cuda(imgs, mats[:-1])
    with pytest.raises(ValueError):
        cuda_warp.affine_warp_cuda(imgs[..., None], mats)
