"""ResNet backbone (port of ``ppn_tpu/nn/resnet.py``): NCHW tensors in
channels_last memory, f32 params, bf16 compute by default.

Module and parameter names follow the JAX tree (``stem``, ``blocks.<i>``,
``conv1``/``conv2``/``conv3``/``proj``, each a ``conv`` + ``bn`` pair) so the
snapshot loader (``utils/params_io.py``) maps leaves one to one.

Hazard — ``padding="SAME"`` is asymmetric on stride 2: XLA pads
``total = max((out-1)·s + k - in, 0)`` with ``total//2`` before and the rest
after. At 384 the 7×7/2 stem pads 2 before and 3 after, every 3×3/2 conv
and the 3×3/2 max-pool pad 0 before and 1 after, a 1×1/2 projection pads
nothing. torch's symmetric ``padding=k//2`` would shift the grid by one
pixel, so ``same_pads`` computes the pads per layer from the input size.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ppn_tpu_torch.ops import cuda_bn

# The process group whose ranks' batches training-mode BatchNorm takes its
# statistics over (None: this process's batch); set by global_batch_stats.
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "ppn_bn_stats_group", default=None)


@contextlib.contextmanager
def global_batch_stats(group):
    """Inside the block, training-mode BatchNorm takes its statistics over
    the joined batch of every rank of ``group`` (a process group, or None
    for this process's batch alone), as the JAX package's BatchNorm does
    over a batch sharded under ``jit``."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``SAME`` for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Pad an NCHW tensor as ``SAME`` would; returns (x, conv padding).

    Symmetric pads go to the conv itself (no copy); asymmetric ones are an
    explicit ``F.pad`` so the grid lines up with the JAX model's."""
    (t, b), (l, r) = (same_pads(x.shape[2], k, s),
                      same_pads(x.shape[3], k, s))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class Conv(nn.Module):
    """Bias-optional conv with ``SAME`` padding, computed in ``dtype``.

    ``weight`` is OIHW f32, initialized as ``nnx.Conv`` does (LeCun normal:
    a normal truncated at ±2σ, scaled to variance 1/fan_in); the bias (the
    head's 1×1 only) is added after the conv in ``dtype``, as ``nnx.Conv``
    does, not inside the cuDNN epilogue."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        # the std of a unit normal truncated at ±2 is 0.8796
        std = (cin * kernel * kernel) ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = pad_same(x, self.kernel, self.stride)
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                     stride=self.stride, padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1, as ``nnx.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` computes it in Flax 0.12, then the activation ``act``
    that follows the layer in the model (None, ``"relu"`` or
    ``"leaky_relu"``, slope 0.1); ``train()``/``eval()`` switch between
    batch and running statistics.

    Eval: every operand is cast to ``dtype`` first and each step rounds
    there, in Flax's order: ``(x - mean) · (rsqrt(var + eps) · scale) +
    bias``; the activation follows eagerly.

    Training (``ops/cuda_bn.py``: the ``ppn_bn_*`` kernels for a CUDA map,
    the plain version for a CPU one): the statistics are taken over N, H, W
    in f32 from the input rounded to ``dtype``, with the fast variance
    ``E[x²] − E[x]²`` clipped at 0. The running update is ``0.9·running +
    0.1·batch`` with that biased variance (``torch.nn.BatchNorm2d`` would
    use the unbiased one). Flax then normalizes in f32, the ``dtype``
    input, scale and bias promoted against the f32 statistics, and rounds
    once to ``dtype``; the activation applies to that value. Gradients flow
    through the batch statistics.

    The statistics come from the per-channel sums Σx, Σx² and the count,
    which inside ``global_batch_stats(group)`` are summed over the group's
    ranks first (one differentiable all-reduce), so every rank normalizes
    by, and updates its running statistics with, the joined batch's. One
    process computes the same formula on its own sums."""

    momentum = 0.9

    def __init__(self, c: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 act=None):
        super().__init__()
        if act not in cuda_bn.ACTS:
            raise ValueError(f"no activation {act!r}")
        self.eps, self.dtype, self.act = eps, dtype, act
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.training:
            return cuda_bn.batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, self.momentum, dt, self.act,
                _STATS_GROUP.get())
        mean = self.running_mean.to(dt)[:, None, None]
        mul = torch.rsqrt(self.running_var.to(dt) + self.eps)
        mul = (mul * self.weight.to(dt))[:, None, None]
        y = (x.to(dt) - mean) * mul + self.bias.to(dt)[:, None, None]
        return cuda_bn.activate(y, self.act)


class ConvBN(nn.Module):
    """Conv → BatchNorm → ``act`` (None: no activation), the unit of every
    ResNet block."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, act=None):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, dtype=dtype)
        self.bn = BatchNorm(cout, dtype=dtype, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block: 3×3 → 3×3 with identity/projection skip."""

    expansion = 1

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, dtype, act="relu")
        self.conv2 = ConvBN(cout, cout, 3, 1, dtype)
        self.proj = (ConvBN(cin, cout, 1, stride, dtype)
                     if (stride != 1 or cin != cout) else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.proj is None else self.proj(x)
        y = self.conv2(self.conv1(x))
        return F.relu(y + skip)   # the residual add rounds in dtype


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck: 1×1 reduce → 3×3 (stride here) → 1×1 expand."""

    expansion = 4

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        cexp = cout * self.expansion
        self.conv1 = ConvBN(cin, cout, 1, 1, dtype, act="relu")
        self.conv2 = ConvBN(cout, cout, 3, stride, dtype, act="relu")
        self.conv3 = ConvBN(cout, cexp, 1, 1, dtype)
        self.proj = (ConvBN(cin, cexp, 1, stride, dtype)
                     if (stride != 1 or cin != cexp) else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.proj is None else self.proj(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + skip)


class ResNet(nn.Module):
    """Stride-32 ResNet feature extractor (stages only, no pool/fc head)."""

    def __init__(self, stage_sizes: Sequence[int],
                 widths: Sequence[int] = (64, 128, 256, 512),
                 block=BasicBlock, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.stem = ConvBN(3, widths[0], 7, 2, dtype, act="relu")
        blocks = []
        cin = widths[0]
        for stage, (n, cout) in enumerate(zip(stage_sizes, widths)):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(block(cin, cout, stride, dtype))
                cin = cout * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.out_features = cin

    def stem_pool(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → (B, 64, H/4, W/4): the stem conv, ReLU and the
        3×3/2 max-pool (``SAME``, padded with -inf)."""
        x = self.stem(x.to(self.dtype))
        x, pad = pad_same(x, 3, 2, value=float("-inf"))
        return F.max_pool2d(x, 3, 2, padding=pad)

    def stages(self) -> list[nn.ModuleList]:
        """The blocks of each stage, split at the cumulative
        ``stage_sizes`` (ResNet-34 and -50: 3, 4, 6 and 3 blocks)."""
        ends = list(itertools.accumulate(self.stage_sizes))
        return [self.blocks[a:b] for a, b in zip([0] + ends, ends)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → (B, C, H/32, W/32)."""
        x = self.stem_pool(x)
        for block in self.blocks:
            x = block(x)
        return x


def resnet18(dtype=torch.bfloat16) -> ResNet:
    return ResNet((2, 2, 2, 2), dtype=dtype)


def resnet34(dtype=torch.bfloat16) -> ResNet:
    return ResNet((3, 4, 6, 3), dtype=dtype)


def resnet50(dtype=torch.bfloat16) -> ResNet:
    return ResNet((3, 4, 6, 3), block=Bottleneck, dtype=dtype)
