"""Training-mode BatchNorm's plain version (``ops/cuda_bn.py``) on the CPU.

The card tests (``tests/test_torch_bn_cuda.py``) hold the ``ppn_bn_*``
kernels to ``grad_sums_plain`` and ``backward_plain``; here those are held
to autograd through the forward the port has always run, and the module
to that forward bitwise: the CPU training path, eval mode and the
state-dict names are as before the kernels came.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.nn import resnet
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.ops import cuda_bn
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPS = 1e-5
ACTS = [None, "relu", "leaky_relu"]
DTYPES = [torch.float32, torch.bfloat16]
SHAPE = (4, 6, 5, 3)
# a value whose channel, constant over the batch, reads a negative fast
# variance in f32 at CLIP_SHAPE, so the clip at 0 engages (asserted below);
# in bfloat16 the same channel's sums are exact and its variance is 0
CLIP_VALUE = 1.7
CLIP_SHAPE = (4, 3, 40, 40)


def _inputs(dtype, seed=0, shape=SHAPE, clip=False):
    g = torch.Generator().manual_seed(seed)
    shape = CLIP_SHAPE if clip else shape
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g) * torch.linspace(0.5, 3.0, c)[:, None, None]
         + torch.linspace(-1.0, 2.0, c)[:, None, None])
    if clip:
        x[:, 0] = CLIP_VALUE
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.1
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, weight, bias, dy


def _eager(x, weight, bias, running_mean, running_var, dtype, act):
    """Training-mode BatchNorm and the activation after it as the model ran
    them before the kernels (the statistics' all-reduce aside)."""
    xf = x.to(dtype).float()
    c = xf.shape[1]
    sums = torch.cat([xf.sum(dim=(0, 2, 3)),
                      torch.square(xf).sum(dim=(0, 2, 3)),
                      xf.new_full((1,), xf.numel() // c)])
    s1, s2, count = sums.split([c, c, 1])
    mean = s1 / count
    var = torch.clamp_min(s2 / count - torch.square(mean), 0.0)
    with torch.no_grad():
        m = 0.9
        running_mean.copy_(m * running_mean + (1 - m) * mean)
        running_var.copy_(m * running_var + (1 - m) * var)
    mul = torch.rsqrt(var + EPS) * weight.to(dtype).float()
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    y = (y + bias.to(dtype).float()[:, None, None]).to(dtype)
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, negative_slope=0.1)
    return y


def _autograd(x, weight, bias, dy, dtype, act):
    x, w, b = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    c = x.shape[1]
    y = cuda_bn.batch_norm_train_plain(x, w, b, torch.zeros(c), torch.ones(c),
                                       EPS, 0.9, dtype, act)
    return torch.autograd.grad(y, (x, w, b), dy)


def _close(got, want, dtype, what):
    """Within f32 rounding of the largest value; one ``dtype`` ulp besides
    where the result rounds to bfloat16."""
    got, want = got.float(), want.float()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + want.abs() * 2.0 ** -8
    assert bool(((got - want).abs() <= tol).all()), (
        what, float((got - want).abs().max()))


@pytest.mark.parametrize("clip", [False, True], ids=["spread", "clip"])
@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_backward_matches_autograd(dtype, act, clip):
    """``grad_sums_plain`` + ``backward_plain``, the kernels' arithmetic,
    against autograd through the forward; with ``clip`` channel 0 is
    constant over the batch: its variance is 0, and in f32 its fast
    variance is negative, so no gradient flows through the variance
    there."""
    x, weight, bias, dy = _inputs(dtype, clip=clip)
    sums = cuda_bn.stats_plain(x.float())
    if clip:
        _, v, var = cuda_bn.channel_stats_plain(sums, EPS)
        assert float(var[0]) == 0.0
        assert float(v[0]) < 0.0 or dtype == torch.bfloat16
    gsums = cuda_bn.grad_sums_plain(dy, x, sums, weight, bias, EPS, act)
    dx, dw, db = cuda_bn.backward_plain(dy, x, sums, gsums, weight, bias,
                                        EPS, act)
    wx, ww, wb = _autograd(x, weight, bias, dy, dtype, act)
    assert dx.dtype == dtype and dx.shape == x.shape
    for got, want, what in ((dx, wx, "dx"), (dw, ww, "dweight"),
                            (db, wb, "dbias")):
        _close(got, want, dtype, what)


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_plain_backward_data_parallel_sums(act):
    """Two ranks' halves of one batch: the forward's sums and the gradient
    sums [A, B] are added over the ranks, the parameter gradients stay each
    rank's. Their concatenation and total are autograd's over the joined
    batch, as ``global_batch_stats`` has it."""
    dtype = torch.float32
    x, weight, bias, dy = _inputs(dtype, seed=3, shape=(6, 5, 4, 3))
    halves = [(x[:2], dy[:2]), (x[2:], dy[2:])]
    sums = sum(cuda_bn.stats_plain(h.float()) for h, _ in halves)
    local = [cuda_bn.grad_sums_plain(d, h, sums, weight, bias, EPS, act)
             for h, d in halves]
    joined = local[0] + local[1]
    parts = [cuda_bn.backward_plain(d, h, sums, joined, weight, bias, EPS,
                                    act, local_gsums=g)
             for (h, d), g in zip(halves, local)]
    wx, ww, wb = _autograd(x, weight, bias, dy, dtype, act)
    _close(torch.cat([p[0] for p in parts]), wx, dtype, "dx")
    _close(parts[0][1] + parts[1][1], ww, dtype, "dweight")
    _close(parts[0][2] + parts[1][2], wb, dtype, "dbias")


@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_module_is_the_eager_formula_bitwise(dtype, act):
    """The module on a CPU map, training then eval: output, gradients and
    running statistics bitwise the eager formula and activation the model
    ran before the kernels."""
    x, weight, bias, dy = _inputs(dtype, seed=1)
    c = x.shape[1]
    bn = resnet.BatchNorm(c, dtype=dtype, act=act)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.normal_(generator=torch.Generator().manual_seed(2))
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = bn.train()(xa)
    w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
    want = _eager(xb, w, b, rm, rv, dtype, act)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
    for g, h in zip(torch.autograd.grad(got, (xa, bn.weight, bn.bias), dy),
                    torch.autograd.grad(want, (xb, w, b), dy)):
        assert torch.equal(g, h)
    with torch.no_grad():
        got = bn.eval()(x)
        dt = dtype
        y = ((x.to(dt) - rm.to(dt)[:, None, None])
             * (torch.rsqrt(rv.to(dt) + EPS) * weight.to(dt))[:, None, None]
             + bias.to(dt)[:, None, None])
        want = {None: y, "relu": F.relu(y),
                "leaky_relu": F.leaky_relu(y, negative_slope=0.1)}[act]
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_blocks_fold_the_activation_where_it_was(block, training):
    """Each block bitwise the composition the model ran before: ReLU after
    the stem's, every BasicBlock ``conv1``'s and every Bottleneck
    ``conv1``'s and ``conv2``'s BatchNorm, none after the last one or the
    projection's, ReLU after the residual add."""
    torch.manual_seed(4)
    cls = resnet.BasicBlock if block == "basic" else resnet.Bottleneck
    blk = cls(8, 8, stride=2, dtype=torch.float32).train(training)
    ref = cls(8, 8, stride=2, dtype=torch.float32).train(training)
    ref.load_state_dict(blk.state_dict())
    x = torch.randn(2, 8, 9, 9)
    folded = {"basic": ("conv1",), "bottleneck": ("conv1", "conv2")}[block]
    assert {n for n, m in blk.named_modules()
            if isinstance(m, resnet.BatchNorm) and m.act == "relu"} == {
                f"{n}.bn" for n in folded}

    def convbn(name, t):
        """Conv, then BatchNorm as the model ran it before, no activation."""
        unit = getattr(ref, name)
        bn, t = unit.bn, unit.conv(t)
        if training:
            return _eager(t, bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, torch.float32, None)
        return ((t - bn.running_mean[:, None, None])
                * (torch.rsqrt(bn.running_var + EPS) * bn.weight)[:, None, None]
                + bn.bias[:, None, None])

    names = ("conv1", "conv2") if block == "basic" else (
        "conv1", "conv2", "conv3")
    with torch.no_grad():
        y = x
        for name in names:
            y = convbn(name, y)
            if name in folded:
                y = F.relu(y)
        want = F.relu(y + convbn("proj", x))
        assert torch.equal(blk(x), want)
    for a, b in zip(blk.buffers(), ref.buffers()):
        assert torch.equal(a, b)
    stem = resnet.resnet18(dtype=torch.float32).stem
    assert stem.bn.act == "relu"


def test_state_dict_names_unchanged():
    """The state-dict names (the snapshot loader maps them one to one) of
    the ResNet-18 and ResNet-50 models, as before the activations moved
    into BatchNorm: their count and the sha256 of the sorted names."""
    import dataclasses

    pins = {"resnet18": (107, "c0cf852b7762a2d4767aab2498fe42d4a6c9c29644d"
                              "460c0876200466a2f1c3f"),
            "resnet50": (272, "76a03ee58b028ae212f317332e16fd3fb9762997c2a"
                              "faaef632e9faa8f85329c")}
    for backbone, (count, digest) in pins.items():
        cfg = dataclasses.replace(get_config("mpii_r18_384").model,
                                  backbone=backbone)
        with torch.device("meta"):
            keys = sorted(PoseProposalNet(cfg).state_dict())
        assert len(keys) == count
        assert hashlib.sha256("\n".join(keys).encode()).hexdigest() == digest
    head = PoseProposalNet(get_config("tiny_test").model).head
    assert head.block.bn.act == "leaky_relu"


def test_dispatch_refuses_what_it_does_not_take():
    x, weight, bias, _ = _inputs(torch.float32)
    c = x.shape[1]
    with pytest.raises(ValueError):
        cuda_bn.batch_norm_train(x, weight, bias, torch.zeros(c),
                                 torch.ones(c), EPS, 0.9, torch.float32,
                                 act="gelu")
    with pytest.raises(ValueError):
        resnet.BatchNorm(c, act="tanh")
    with pytest.raises(ValueError):
        cuda_bn.forward_cuda(x, weight, bias, torch.zeros(c), torch.ones(c),
                             EPS, 0.9)
    assert np.isfinite(cuda_bn.batch_norm_train(
        x, weight, bias, torch.zeros(c), torch.ones(c), EPS, 0.9,
        torch.float32, act="relu").detach().numpy()).all()
