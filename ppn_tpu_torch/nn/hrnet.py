"""HRNet-W32 trunk: four resolutions side by side, joined by exchange units
(Sun et al., *Deep High-Resolution Representation Learning for Human Pose
Estimation*, CVPR 2019), with the classification network's stride-32
representation head (HRNet-W32-C of Wang et al., TPAMI 2020) and without
its pooling and classifier, so that the PPN head takes a 2048-channel map
at stride 32, as it does from ResNet-50.

Built from ``nn/resnet.py``'s ``ConvBN``, ``BasicBlock`` and ``Bottleneck``
(NCHW tensors in channels_last memory, f32 parameters, compute in
``dtype``; training-mode BatchNorm on the ``ppn_bn_*`` kernels):

- stem: two 3×3/2 ConvBN + ReLU to 64 channels (stride 4);
- ``layer1``: 4 Bottlenecks, 64 → 256;
- ``transition1``: a 3×3 ConvBN + ReLU to 32 at stride 4 and a 3×3/2 one
  to 64 at stride 8; ``transition2``/``3`` open the third and fourth
  branch from the last one with a 3×3/2 ConvBN + ReLU;
- ``stage2``/``3``/``4``: 1, 4 and 3 modules over 2, 3 and 4 branches of
  widths 32, 64, 128, 256; a module runs 4 BasicBlocks a branch, then its
  exchange unit (``Exchange``);
- head: each branch through one Bottleneck (``incre``: 128, 256, 512,
  1024 channels), ``y = incre_i(x_i) + down_{i−1}(y)`` with each ``down`` a
  3×3/2 ConvBN + ReLU, then a 1×1 ConvBN + ReLU to 2048 (``final``).

Departures from the published code: every convolution pads as
TensorFlow's ``SAME`` (the port's ``Conv``), which on a 3×3/2 over an even
map pads (0, 1) where the published code pads (1, 1); the head's
downsampling and final convolutions carry no bias (BatchNorm follows each,
so a bias would only shift its mean); no pooling or classifier.

Each exchange unit's forward runs inside ``record_function("ppn.hrnet.fuse")``
and adds one to ``FUSES``; the head runs inside
``record_function("ppn.hrnet.head")``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ppn_tpu_torch.nn.resnet import BasicBlock, Bottleneck, ConvBN

# Exchange units run in this process (8 a forward of HRNet-W32).
FUSES = 0

FUSE_SPAN = "ppn.hrnet.fuse"
HEAD_SPAN = "ppn.hrnet.head"

WIDTHS = (32, 64, 128, 256)     # the branches of HRNet-W32
MODULES = (1, 4, 3)             # modules of stages 2, 3 and 4
BLOCKS = 4                      # BasicBlocks a branch in a module
HEAD = (32, 64, 128, 256)       # the head's Bottleneck widths (x4 out)


class Exchange(nn.ModuleList):
    """The exchange unit over branches of ``widths`` (highest resolution
    first): output i = ReLU(Σ_j f_ij(x_j)), summed in j's order, where
    f_ii is the identity; for j > i a 1×1 ConvBN to width i, then nearest
    upsampling by 2^(j−i); for j < i, i − j 3×3/2 ConvBNs, each but the
    last at width j with a ReLU, the last to width i without one. Row i of
    the list holds f_i0 .. f_i(n−1)."""

    def __init__(self, widths: Sequence[int], dtype=torch.bfloat16):
        rows = []
        for i, ci in enumerate(widths):
            row = []
            for j, cj in enumerate(widths):
                if j == i:
                    row.append(nn.Identity())
                elif j > i:
                    row.append(ConvBN(cj, ci, 1, 1, dtype))
                else:
                    row.append(nn.Sequential(*(
                        ConvBN(cj, ci, 3, 2, dtype) if k == i - j - 1
                        else ConvBN(cj, cj, 3, 2, dtype, act="relu")
                        for k in range(i - j))))
            rows.append(nn.ModuleList(row))
        super().__init__(rows)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        global FUSES
        FUSES += 1
        with torch.profiler.record_function(FUSE_SPAN):
            out = []
            for i, row in enumerate(self):
                y = None
                for j, (f, x) in enumerate(zip(row, xs)):
                    t = f(x)
                    if j > i:
                        t = F.interpolate(t, scale_factor=2 ** (j - i),
                                          mode="nearest")
                    y = t if y is None else y + t
                out.append(F.relu(y))
            return out


class HRModule(nn.Module):
    """One module: ``BLOCKS`` BasicBlocks on each branch, then the
    exchange unit."""

    def __init__(self, widths: Sequence[int], dtype=torch.bfloat16):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c, 1, dtype) for _ in range(BLOCKS)))
            for c in widths)
        self.fuse = Exchange(widths, dtype)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return self.fuse([b(x) for b, x in zip(self.branches, xs)])


class HRNet(nn.Module):
    """HRNet-W32 with the stride-32 representation head:
    (B, 3, H, W) → (B, 2048, H/32, W/32)."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = WIDTHS
        self.stem = nn.Sequential(ConvBN(3, 64, 3, 2, dtype, act="relu"),
                                  ConvBN(64, 64, 3, 2, dtype, act="relu"))
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if i == 0 else 256, 64, 1, dtype) for i in range(4)))
        self.transition1 = nn.ModuleList([
            ConvBN(256, w[0], 3, 1, dtype, act="relu"),
            ConvBN(256, w[1], 3, 2, dtype, act="relu")])
        self.stage2 = nn.ModuleList(HRModule(w[:2], dtype)
                                    for _ in range(MODULES[0]))
        self.transition2 = ConvBN(w[1], w[2], 3, 2, dtype, act="relu")
        self.stage3 = nn.ModuleList(HRModule(w[:3], dtype)
                                    for _ in range(MODULES[1]))
        self.transition3 = ConvBN(w[2], w[3], 3, 2, dtype, act="relu")
        self.stage4 = nn.ModuleList(HRModule(w, dtype)
                                    for _ in range(MODULES[2]))
        self.incre = nn.ModuleList(Bottleneck(c, h, 1, dtype)
                                   for c, h in zip(w, HEAD))
        self.down = nn.ModuleList(
            ConvBN(4 * HEAD[i], 4 * HEAD[i + 1], 3, 2, dtype, act="relu")
            for i in range(3))
        self.final = ConvBN(4 * HEAD[3], 2048, 1, 1, dtype, act="relu")
        self.out_features = 2048

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer1(self.stem(x.to(self.dtype)))
        xs = [t(x) for t in self.transition1]
        for m in self.stage2:
            xs = m(xs)
        xs = xs + [self.transition2(xs[-1])]
        for m in self.stage3:
            xs = m(xs)
        xs = xs + [self.transition3(xs[-1])]
        for m in self.stage4:
            xs = m(xs)
        with torch.profiler.record_function(HEAD_SPAN):
            y = self.incre[0](xs[0])
            for i, down in enumerate(self.down):
                y = self.incre[i + 1](xs[i + 1]) + down(y)
            return self.final(y)
