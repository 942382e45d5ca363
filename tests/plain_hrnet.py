"""Plain PyTorch reference of the PPN model on the HRNet-W32 trunk, in
float32, for the tier-1 tests: Sun et al., CVPR 2019 (arXiv:1902.09212),
with the stride-32 representation head of HRNet-W32-C (Wang et al., TPAMI
2020, arXiv:1908.07919) and the PPN head (Sekii, ECCV 2018).

It imports nothing of the port: the trunk is written out as functions of
a dictionary of named tensors under the port's module names
(``backbone.stem.0.conv.weight``, ``backbone.stage2.0.fuse.0.1.bn.bias``,
``head.out.weight``, ...), each conv padded as TensorFlow's ``SAME`` and
each BatchNorm computed from its definition (the two-pass biased variance,
momentum 0.9 on the running statistics, eps 1e-5).

Departures from the papers, as the port makes them: ``SAME`` padding (a
3x3 stride-2 conv on an even map pads (0, 1) where the published code pads
(1, 1)); no bias on the head's downsampling and final convs (BatchNorm
follows each); no pooling or classifier: the PPN head (a 3x3 conv to 512,
BatchNorm, LeakyReLU(0.1), then a 1x1 conv with bias) takes the
2048-channel stride-32 map in the classifier's place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STEM = 64
LAYER1 = (4, 64)                    # bottlenecks, their width (x4 out)
WIDTHS = (32, 64, 128, 256)         # the four branches
MODULES = (1, 4, 3)                 # stages 2, 3 and 4
BLOCKS = 4                          # basic blocks a branch, a module
INCRE = (32, 64, 128, 256)          # the head's bottlenecks (x4 out)
FINAL = 2048
HEAD = 512
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS, MOMENTUM, SLOPE = 1e-5, 0.9, 0.1

Params = Dict[str, torch.Tensor]
Spec = Tuple[str, int, int, int, int, bool]


def _bottleneck(pre: str, cin: int, c: int) -> List[Spec]:
    out = [(f"{pre}.conv1", cin, c, 1, 1, True),
           (f"{pre}.conv2", c, c, 3, 1, True),
           (f"{pre}.conv3", c, 4 * c, 1, 1, True)]
    if cin != 4 * c:
        out.append((f"{pre}.proj", cin, 4 * c, 1, 1, True))
    return out


def _modules():
    """(prefix, number of branches) of every module, in order."""
    for s, n in enumerate(MODULES):
        for k in range(n):
            yield f"backbone.stage{s + 2}.{k}", s + 2


def conv_specs(num_channels: int) -> List[Spec]:
    """(name, cin, cout, kernel, stride, followed by BatchNorm) of every
    convolution, in forward order; ``num_channels`` is the head's output."""
    specs = [("backbone.stem.0", 3, STEM, 3, 2, True),
             ("backbone.stem.1", STEM, STEM, 3, 2, True)]
    cin = STEM
    for i in range(LAYER1[0]):
        specs += _bottleneck(f"backbone.layer1.{i}", cin, LAYER1[1])
        cin = 4 * LAYER1[1]
    specs += [("backbone.transition1.0", cin, WIDTHS[0], 3, 1, True),
              ("backbone.transition1.1", cin, WIDTHS[1], 3, 2, True)]
    opened = 2
    for pre, n in _modules():
        if n > opened:
            specs.append((f"backbone.transition{n - 1}", WIDTHS[n - 2],
                          WIDTHS[n - 1], 3, 2, True))
            opened = n
        for b in range(n):
            for k in range(BLOCKS):
                c = WIDTHS[b]
                specs += [(f"{pre}.branches.{b}.{k}.conv1", c, c, 3, 1, True),
                          (f"{pre}.branches.{b}.{k}.conv2", c, c, 3, 1, True)]
        for i in range(n):
            for j in range(n):
                if j > i:
                    specs.append((f"{pre}.fuse.{i}.{j}", WIDTHS[j],
                                  WIDTHS[i], 1, 1, True))
                for k in range(i - j):
                    cout = WIDTHS[i] if k == i - j - 1 else WIDTHS[j]
                    specs.append((f"{pre}.fuse.{i}.{j}.{k}", WIDTHS[j], cout,
                                  3, 2, True))
    for i, (c, h) in enumerate(zip(WIDTHS, INCRE)):
        specs += _bottleneck(f"backbone.incre.{i}", c, h)
    for i in range(3):
        specs.append((f"backbone.down.{i}", 4 * INCRE[i], 4 * INCRE[i + 1],
                      3, 2, True))
    specs += [("backbone.final", 4 * INCRE[3], FINAL, 1, 1, True),
              ("head.block", FINAL, HEAD, 3, 1, True),
              ("head.out", HEAD, num_channels, 1, 1, False)]
    return specs


def param_shapes(num_channels: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name → (shape, kind), kind one of conv, bias, bn_weight, bn_bias,
    bn_mean, bn_var."""
    out = {}
    for name, cin, cout, k, _, bn in conv_specs(num_channels):
        if bn:
            out[f"{name}.conv.weight"] = ((cout, cin, k, k), "conv")
            for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                               ("running_mean", "bn_mean"),
                               ("running_var", "bn_var")):
                out[f"{name}.bn.{leaf}"] = ((cout,), kind)
        else:
            out[f"{name}.weight"] = ((cout, cin, k, k), "conv")
            out[f"{name}.bias"] = ((cout,), "bias")
    return out


def buffer_names(num_channels: int) -> List[str]:
    return [n for n, (_, kind) in param_shapes(num_channels).items()
            if kind in ("bn_mean", "bn_var")]


def _same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Layers:
    """The conv + BatchNorm of a named layer and the bottleneck over one
    dictionary of tensors, in batch (``train``) or running statistics."""

    def __init__(self, p: Params, train: bool, stats: Optional[Params]):
        self.p, self.train, self.stats = p, train, stats

    def convbn(self, name, x, stride, relu=False):
        p = self.p
        w = p[f"{name}.conv.weight"]
        y = F.conv2d(_same(x, w.shape[-1], stride), w, stride=stride)
        if self.train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            if self.stats is not None:
                with torch.no_grad():
                    for leaf, v in (("running_mean", mean),
                                    ("running_var", var)):
                        key = f"{name}.bn.{leaf}"
                        self.stats[key] = (MOMENTUM * self.stats[key]
                                           + (1 - MOMENTUM) * v.detach())
        else:
            mean = p[f"{name}.bn.running_mean"]
            var = p[f"{name}.bn.running_var"]
        mul = torch.rsqrt(var + EPS) * p[f"{name}.bn.weight"]
        y = ((y - mean[:, None, None]) * mul[:, None, None]
             + p[f"{name}.bn.bias"][:, None, None])
        return F.relu(y) if relu else y

    def bottleneck(self, pre, x):
        skip = (self.convbn(f"{pre}.proj", x, 1)
                if f"{pre}.proj.conv.weight" in self.p else x)
        y = self.convbn(f"{pre}.conv1", x, 1, True)
        y = self.convbn(f"{pre}.conv2", y, 1, True)
        return F.relu(self.convbn(f"{pre}.conv3", y, 1) + skip)


def trunk(p: Params, images: torch.Tensor, train: bool = False,
          stats: Optional[Params] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 or [0, 1] float images → the trunk's
    (B, 2048, H/32, W/32) f32 map. ``train``: batch statistics, and the
    running statistics updated into ``stats`` when given."""
    L = _Layers(p, train, stats)
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images
    # float images are normalized in their own dtype, as the model defines
    # it (a bfloat16 augmented batch rounds there), then taken to f32
    x = ((x - torch.tensor(MEAN, dtype=x.dtype))
         / torch.tensor(STD, dtype=x.dtype)).float().permute(0, 3, 1, 2)
    x = L.convbn("backbone.stem.1", L.convbn("backbone.stem.0", x, 2, True),
                 2, True)
    for i in range(LAYER1[0]):
        x = L.bottleneck(f"backbone.layer1.{i}", x)
    xs = [L.convbn("backbone.transition1.0", x, 1, True),
          L.convbn("backbone.transition1.1", x, 2, True)]
    for pre, n in _modules():
        if n > len(xs):
            xs.append(L.convbn(f"backbone.transition{n - 1}", xs[-1], 2,
                               True))
        for b in range(n):
            for k in range(BLOCKS):
                bp = f"{pre}.branches.{b}.{k}"
                y = L.convbn(f"{bp}.conv1", xs[b], 1, True)
                xs[b] = F.relu(L.convbn(f"{bp}.conv2", y, 1) + xs[b])
        fused = []
        for i in range(n):
            y = None
            for j in range(n):
                t = xs[j]
                if j > i:
                    f = 2 ** (j - i)
                    t = L.convbn(f"{pre}.fuse.{i}.{j}", t, 1)
                    t = t.repeat_interleave(f, 2).repeat_interleave(f, 3)
                for k in range(i - j):
                    t = L.convbn(f"{pre}.fuse.{i}.{j}.{k}", t, 2,
                                 k < i - j - 1)
                y = t if y is None else y + t
            fused.append(F.relu(y))
        xs = fused
    y = L.bottleneck("backbone.incre.0", xs[0])
    for i in range(1, 4):
        y = (L.bottleneck(f"backbone.incre.{i}", xs[i])
             + L.convbn(f"backbone.down.{i - 1}", y, 2, True))
    return L.convbn("backbone.final", y, 1, True)


def forward(p: Params, images: torch.Tensor, train: bool = False,
            stats: Optional[Params] = None) -> torch.Tensor:
    """The trunk, then the PPN head: → (B, H/32, W/32, C) f32."""
    y = trunk(p, images, train, stats)
    y = F.leaky_relu(_Layers(p, train, stats).convbn("head.block", y, 1),
                     SLOPE)
    y = F.conv2d(y, p["head.out.weight"]) + p["head.out.bias"][:, None, None]
    return y.permute(0, 2, 3, 1)
