"""The ppn_bn_* kernels (CUDA) against their plain PyTorch version, on the
card.

Needs an NVIDIA GPU with nvcc; without one every test here skips. Run on
the card with ``python -m pytest --noconftest tests/test_torch_bn_cuda.py``
(the repo's conftest imports JAX, which the GPU machine does not need).

The sums are held within f32 rounding: the kernels add in another order
than PyTorch's reductions, so |Δ| ≤ 1e-5 of the sum of the terms'
magnitudes. Everything after the sums is elementwise arithmetic in the
plain version's order (the kernels are built without FMA contraction), so
given the kernels' own sums the plain version must give ``y``, ``dx`` and
the parameter gradients within one ulp of their dtype; the share of
values that differ at all is printed (``-s``) and expected to be 0.
"""

import numpy as np
import pytest
import torch

from ppn_tpu_torch.ops import cuda_bn
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.cuda,
              pytest.mark.usefixtures("one_torch_thread")]

EPS, MOMENTUM = 1e-5, 0.9
ACTS = [None, "relu", "leaky_relu"]
DTYPES = [torch.float32, torch.bfloat16]
# (channels, side) of every distinct BatchNorm map of ResNet-18, ResNet-50
# and HRNet-W32 at 384², the head's included
R18 = [(64, 192), (64, 96), (128, 48), (256, 24), (512, 12)]
R50 = [(64, 192), (64, 96), (256, 96), (128, 96), (128, 48), (512, 48),
       (256, 48), (256, 24), (1024, 24), (512, 24), (512, 12), (2048, 12)]
HRW32 = [(32, 96), (32, 48), (32, 24), (32, 12), (64, 192), (64, 96),
         (64, 48), (64, 24), (64, 12), (128, 96), (128, 24), (128, 12),
         (256, 96), (256, 48), (256, 12), (512, 24), (512, 12), (1024, 12),
         (2048, 12)]
SHAPES = ([(8, c, s) for c, s in sorted(set(R18 + R50 + HRW32))]
          + [(128, 64, 192), (128, 32, 96)])


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(B, C, side, dtype, dev, seed=0, channels_last=True):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    shift, spread = randn(C), randn(C).abs() + 0.5
    x = randn(B, side, side, C) * spread + shift            # NHWC memory
    x = x.to(dtype).permute(0, 3, 1, 2)
    if not channels_last:
        x = x.contiguous()
    weight = randn(C).abs() + 0.5
    bias = 0.1 * randn(C)
    dy = randn(B, side, side, C).to(dtype).permute(0, 3, 1, 2)
    return x, weight, bias, dy


def _ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each value of ``t`` (f32 held)."""
    _, e = torch.frexp(t.float().abs().clamp_min(torch.finfo(dtype).tiny))
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - bits)


def _within_ulp(got, want, what):
    d = (got.float() - want.float()).abs()
    share = float((d > 0).float().mean())
    print(f"{what}: {share:.3g} of {d.numel()} values differ, max |Δ| "
          f"{float(d.max()):.3g}")
    assert bool((d <= _ulp(want, want.dtype)).all()), (what, share)
    return share


def _within_f32(got, want, scale, what):
    d = (got - want).abs()
    assert bool((d <= 1e-5 * scale).all()), (
        what, float((d / scale.clamp_min(1e-30)).max()))


def _check(x, weight, bias, dy, act):
    """Forward and backward through the kernels against the plain
    version; returns the kernels' outputs."""
    dev, dtype, C = x.device, x.dtype, x.shape[1]
    g = torch.Generator(device=dev).manual_seed(7)
    rm0, rv0 = torch.randn(C, generator=g, device=dev), torch.ones(C, device=dev)
    rm, rv = rm0.clone(), rv0.clone()
    before = cuda_bn.LAUNCHES
    y, sums = cuda_bn.forward_cuda(x, weight, bias, rm, rv, EPS, MOMENTUM,
                                   act)
    dx, dw, db, gsums = cuda_bn.backward_cuda(dy, x, sums, weight, bias, EPS,
                                              act)
    torch.cuda.synchronize()
    assert cuda_bn.LAUNCHES == before + 6
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    xf = x.float()
    # the statistics within f32 rounding of the sums of magnitudes
    _within_f32(sums, cuda_bn.stats_plain(xf),
                cuda_bn.stats_plain(xf.abs()), "sums")
    # the apply given the kernels' sums, and the running statistics
    prm, prv = rm0.clone(), rv0.clone()
    want = cuda_bn.apply_plain(xf, sums, weight, bias, prm, prv, EPS,
                               MOMENTUM, dtype, act)
    _within_ulp(y, want, "y")
    _within_ulp(rm, prm, "running_mean")
    _within_ulp(rv, prv, "running_var")
    # the running statistics of the plain version's own sums
    orm, orv = rm0.clone(), rv0.clone()
    cuda_bn.batch_norm_train_plain(x, weight, bias, orm, orv, EPS, MOMENTUM,
                                   dtype, act)
    n = xf.numel() / C
    _within_f32(rm, orm, 0.1 * xf.abs().sum((0, 2, 3)) / n + rm0.abs(),
                "running_mean of the plain sums")
    _within_f32(rv, orv, 0.3 * torch.square(xf).sum((0, 2, 3)) / n + rv0,
                "running_var of the plain sums")
    # the gradient sums within f32 rounding
    mean = sums[:C] / sums[2 * C]
    dyf = dy.float().abs()
    scale = torch.cat([dyf.sum((0, 2, 3)), (dyf * (xf - mean[:, None, None])
                                            .abs()).sum((0, 2, 3))])
    _within_f32(gsums, cuda_bn.grad_sums_plain(dy, x, sums, weight, bias, EPS,
                                               act), scale, "gradient sums")
    # dx and the parameter gradients given the kernels' sums
    pdx, pdw, pdb = cuda_bn.backward_plain(dy, x, sums, gsums, weight, bias,
                                           EPS, act)
    _within_ulp(dx, pdx, "dx")
    _within_ulp(dw.to(dtype), pdw.to(dtype), "dweight")
    _within_ulp(db.to(dtype), pdb.to(dtype), "dbias")
    return y, sums, dx, dw, db, rm, rv


@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dC%dS%d" % s)
def test_kernels_match_plain(device, shape, dtype, act):
    _check(*_case(*shape, dtype, device), act)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape, channels_last", [
    ((2, 2056, 3), True),    # a last chunk of one vector beyond 256
    ((3, 40, 9), True),      # a row of 5 (bf16) or 10 (f32) vectors
    ((2, 24, 7), False),     # an NCHW-contiguous map, copied to channels_last
    ((1, 8, 1), True),       # one row, one value a channel
])
def test_kernels_match_plain_on_edge_shapes(device, shape, channels_last,
                                            dtype):
    for act in ACTS:
        _check(*_case(*shape, dtype, device, seed=1,
                      channels_last=channels_last), act)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_two_calls_bitwise(device, dtype):
    """No float atomics, sums in a fixed order: the same input gives the
    same bits, outputs and running statistics alike."""
    case = _case(8, 64, 96, dtype, device, seed=2)
    a, b = _check(*case, "relu"), _check(*case, "relu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_constant_channel_clips(device):
    """A channel constant over the batch: its variance is 0 up to the
    rounding of the sums; where the kernels' fast variance reads negative
    (for some of these constants) the clip holds it at 0 and no gradient
    flows through it, as in the plain version."""
    clipped = 0
    for dtype in DTYPES:
        for value in (0.7, 1.1, 1.7, 2.2, 2.7, 3.4, 5.3, 6.1):
            x, weight, bias, dy = _case(8, 64, 48, dtype, device, seed=3)
            x = x.clone()
            x[:, 0] = value
            _, sums, *_ = _check(x, weight, bias, dy, "relu")
            _, v, var = cuda_bn.channel_stats_plain(sums, EPS)
            assert float(var[0]) <= 1e-5 * value * value
            if float(v[0]) < 0.0:
                clipped += 1
                assert float(var[0]) == 0.0
    print(f"clip engaged for {clipped} of 16 constant channels")
    assert clipped > 0


def test_rejects_what_it_does_not_take(device):
    x, weight, bias, _ = _case(2, 8, 4, torch.float32, device)
    rm, rv = torch.zeros(8, device=device), torch.ones(8, device=device)
    with pytest.raises(TypeError):
        cuda_bn.forward_cuda(x.double(), weight, bias, rm, rv, EPS, MOMENTUM)
    with pytest.raises(ValueError):
        cuda_bn.forward_cuda(x, weight[:-1], bias, rm, rv, EPS, MOMENTUM)
    with pytest.raises(ValueError):
        cuda_bn.forward_cuda(x[0], weight, bias, rm, rv, EPS, MOMENTUM)


@pytest.mark.parametrize("dtype, C", [(torch.float32, 3),
                                      (torch.float32, 6),
                                      (torch.bfloat16, 12),
                                      (torch.bfloat16, 1)])
def test_rejects_channels_under_16_bytes(device, dtype, C):
    """The kernels move 16 bytes a thread: a C that is not a multiple of 4
    (f32) or 8 (bf16) values is refused, forward and backward."""
    x, weight, bias, dy = _case(2, C, 5, dtype, device)
    rm, rv = torch.zeros(C, device=device), torch.ones(C, device=device)
    with pytest.raises(ValueError, match="multiples"):
        cuda_bn.forward_cuda(x, weight, bias, rm, rv, EPS, MOMENTUM)
    sums = torch.ones(2 * C + 1, device=device)
    with pytest.raises(ValueError, match="multiples"):
        cuda_bn.backward_cuda(dy, x, sums, weight, bias, EPS)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rejects_maps_off_16_bytes(device, dtype):
    """A channels_last view one value past a 16-byte boundary, as the map
    or as its upstream gradient, is refused."""
    x, weight, bias, dy = _case(2, 8, 5, dtype, device)
    rm, rv = torch.zeros(8, device=device), torch.ones(8, device=device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        v = flat[1:].view(2, 5, 5, 8).permute(0, 3, 1, 2)
        v.copy_(t)
        return v

    with pytest.raises(ValueError, match="16-byte"):
        cuda_bn.forward_cuda(shifted(x), weight, bias, rm, rv, EPS, MOMENTUM)
    _, sums = cuda_bn.forward_cuda(x, weight, bias, rm, rv, EPS, MOMENTUM)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_bn.backward_cuda(shifted(dy), x, sums, weight, bias, EPS)


def test_every_training_batch_norm_goes_through_the_kernels(device):
    """One K=2 ``make_multi_train_step`` call on tiny_test: every
    training-mode BatchNorm layer of the model launches the kernels' 3
    forward and 3 backward kernels at each step."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.nn.resnet import BatchNorm
    from ppn_tpu_torch.train import steps as st

    cfg = get_config("tiny_test")
    K, B = 2, cfg.train.batch_size
    state = st.create_train_state(cfg, device=device)
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=8, seed=0),
                        device=device)
    layers = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    assert layers == 21
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=K)
    idx = np.arange(K * B, dtype=np.int32).reshape(K, B)
    before = cuda_bn.LAUNCHES
    terms = multi(state, cache, idx)
    torch.cuda.synchronize()
    assert cuda_bn.LAUNCHES - before == K * layers * 6
    assert all(bool(torch.isfinite(t)) for t in terms.values())
