"""The plain reference of the PPN model on the HRNet-W32 trunk: Sun et al.,
*Deep High-Resolution Representation Learning for Human Pose Estimation*,
CVPR 2019 (arXiv:1902.09212), with the stride-32 representation head of
HRNet-W32-C (Wang et al., TPAMI 2020, arXiv:1908.07919), then the PPN head
(Sekii, ECCV 2018), as functions of a dictionary of float32 tensors, from
a configuration file's ``model`` group.

It imports nothing of the program; the convolution, BatchNorm and
rounding of ``reference/model.py`` are shared. Parameter names follow the
configuration's module tree (``backbone.stem.0.conv.weight``,
``backbone.stage3.2.fuse.2.0.1.bn.weight``, ``head.out.bias``, ...).

The trunk, as published:
- stem: two 3x3 stride-2 convs to ``stem_width``, each with BatchNorm and
  ReLU; ``layer1``: ``stage1_blocks`` bottlenecks of ``stage1_width``
  (x4 out), a 1x1 projection on the first;
- ``transition1``: a 3x3 conv, BatchNorm and ReLU to each of the first two
  branch widths, the second at stride 2; ``transition2``/``3``: a 3x3
  stride-2 conv, BatchNorm and ReLU from the last branch opens the next;
- ``stage2``/``3``/``4``: ``stage_modules`` modules over ``stage_branches``
  branches of ``branch_widths``; each branch runs ``branch_blocks`` basic
  blocks, then the exchange: output i = ReLU(sum over j of f_ij(x_j)),
  f_ii the identity, for j > i a 1x1 conv and BatchNorm then nearest
  upsampling by 2^(j-i), for j < i (i - j) 3x3 stride-2 convs with
  BatchNorm, a ReLU after each but the last, the last to width i; every
  module keeps all its outputs;
- head: each branch through one bottleneck of ``incre_widths`` (x4 out);
  y = incre_0(x_0), then y = incre_i(x_i) + down_(i-1)(y), each down a 3x3
  stride-2 conv, BatchNorm and ReLU; last a 1x1 conv, BatchNorm and ReLU
  to ``final_width``.

Departures from the papers: TensorFlow's ``SAME`` padding, so a 3x3
stride-2 conv on an even map pads (0, 1) where the published code pads
(1, 1); the head's downsampling and final convs have no bias (BatchNorm
follows each); no pooling or classifier: the PPN head (a 3x3 ConvBN and
LeakyReLU(0.1), then a 1x1 conv with bias) takes the 2048-channel stride-32
map in the classifier's place.

``checkpoint``: in training, each stem conv, each ``layer1`` block, each
transition, each module and the head are recomputed in the backward
(``torch.utils.checkpoint``) rather than kept, so that a float32 step fits
at B=128; the arithmetic is the same, and the running statistics are
updated once, by the first forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from perfbench.reference.model import _bn, _conv, num_channels, rounded

Params = Dict[str, torch.Tensor]
Spec = Tuple[str, int, int, int, int, bool]
Conv = Tuple[str, int, int, int, int, bool, int]


def _bottleneck(pre: str, cin: int, c: int, at: int) -> List[Conv]:
    out = [(f"{pre}.conv1", cin, c, 1, 1, True, at),
           (f"{pre}.conv2", c, c, 3, 1, True, at),
           (f"{pre}.conv3", c, 4 * c, 1, 1, True, at)]
    if cin != 4 * c:
        out.append((f"{pre}.proj", cin, 4 * c, 1, 1, True, at))
    return out


def _exchange(pre: str, widths: List[int]) -> List[Conv]:
    out = []
    for i, ci in enumerate(widths):
        for j, cj in enumerate(widths):
            if j > i:
                # the 1x1 runs at branch j's size, before the upsampling
                out.append((f"{pre}.{i}.{j}", cj, ci, 1, 1, True, 4 << j))
            for k in range(i - j):
                last = k == i - j - 1
                out.append((f"{pre}.{i}.{j}.{k}", cj, ci if last else cj, 3,
                            2, True, 4 << (j + k + 1)))
    return out


def _stages(m: dict):
    """(module prefix, branch widths) of every module, in order."""
    for s, (n, b) in enumerate(zip(m["stage_modules"], m["stage_branches"])):
        for k in range(n):
            yield f"backbone.stage{s + 2}.{k}", m["branch_widths"][:b]


def _convs(m: dict) -> List[Conv]:
    """(name, cin, cout, kernel, stride, followed by BatchNorm, output
    stride in input pixels) of every convolution, in forward order."""
    sw, c1, w = m["stem_width"], m["stage1_width"], m["branch_widths"]
    out = [("backbone.stem.0", 3, sw, 3, 2, True, 2),
           ("backbone.stem.1", sw, sw, 3, 2, True, 4)]
    cin = sw
    for i in range(m["stage1_blocks"]):
        out += _bottleneck(f"backbone.layer1.{i}", cin, c1, 4)
        cin = 4 * c1
    out += [("backbone.transition1.0", cin, w[0], 3, 1, True, 4),
            ("backbone.transition1.1", cin, w[1], 3, 2, True, 8)]
    last = w[:2]
    for pre, widths in _stages(m):
        if len(widths) > len(last):
            n = len(widths)
            out.append((f"backbone.transition{n - 1}", last[-1], widths[-1],
                        3, 2, True, 4 << (n - 1)))
        for b, c in enumerate(widths):
            for k in range(m["branch_blocks"]):
                bp = f"{pre}.branches.{b}.{k}"
                out += [(f"{bp}.conv1", c, c, 3, 1, True, 4 << b),
                        (f"{bp}.conv2", c, c, 3, 1, True, 4 << b)]
        out += _exchange(f"{pre}.fuse", widths)
        last = widths
    inc = m["incre_widths"]
    for i, (c, h) in enumerate(zip(w, inc)):
        out += _bottleneck(f"backbone.incre.{i}", c, h, 4 << i)
    for i in range(len(inc) - 1):
        out.append((f"backbone.down.{i}", 4 * inc[i], 4 * inc[i + 1], 3, 2,
                    True, 8 << i))
    top = 4 << (len(inc) - 1)
    out.append(("backbone.final", 4 * inc[-1], m["final_width"], 1, 1, True,
                top))
    hw = m["head_width"]
    out += [("head.block", m["final_width"], hw, 3, 1, True, top),
            ("head.out", hw, num_channels(m), 1, 1, False, top)]
    return out


def conv_specs(m: dict) -> List[Spec]:
    """(name, cin, cout, kernel, stride, followed by BatchNorm) of every
    convolution, in forward order."""
    return [c[:6] for c in _convs(m)]


def conv_strides(m: dict) -> Dict[str, int]:
    """Each convolution's output stride (input pixels per pixel of its
    map), by name."""
    return {c[0]: c[6] for c in _convs(m)}


def param_shapes(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter and BatchNorm statistic: name → (shape, kind), kind
    one of conv, bias, bn_weight, bn_bias, bn_mean, bn_var."""
    out = {}
    for name, cin, cout, k, _, bn in conv_specs(m):
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


def buffer_names(m: dict) -> List[str]:
    return [n for n, (_, kind) in param_shapes(m).items()
            if kind in ("bn_mean", "bn_var")]


def _upsample(x: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest upsampling by ``f``: each value repeated f x f times."""
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def forward(m: dict, p: Params, images: torch.Tensor, train: bool = False,
            stats: Optional[Params] = None, precision: str = "float32",
            checkpoint: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 or float images → (B, H', W', C) float32 map.
    ``train``: BatchNorm on the batch's statistics, and the running
    statistics updated into ``stats`` when given."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(m["normalize_mean"], device=x.device)
    std = torch.tensor(m["normalize_std"], device=x.device)
    x = rounded(((x - mean) / std).permute(0, 3, 1, 2), precision)
    r = lambda t: rounded(t, precision)  # noqa: E731

    def seg(fn, *xs):
        """fn(stats, *xs), recomputed in the backward under ``checkpoint``;
        only its first run updates the running statistics."""
        if not (checkpoint and train):
            return fn(stats, *xs)
        runs = []

        def once(*a):
            st = stats if not runs else None
            runs.append(1)
            return fn(st, *a)

        return _checkpoint(once, *xs, use_reentrant=False)

    def convbn(st, name, x, stride, relu=False):
        y = r(_bn(p, name, _conv(x, p[f"{name}.conv.weight"], stride,
                                 precision), train, m, st))
        return F.relu(y) if relu else y

    def bottleneck(st, pre, x):
        skip = (convbn(st, f"{pre}.proj", x, 1)
                if f"{pre}.proj.conv.weight" in p else x)
        y = convbn(st, f"{pre}.conv1", x, 1, True)
        y = convbn(st, f"{pre}.conv2", y, 1, True)
        y = convbn(st, f"{pre}.conv3", y, 1)
        return F.relu(r(y + skip))

    def module(st, pre, *xs):
        xs = list(xs)
        for b in range(len(xs)):
            for k in range(m["branch_blocks"]):
                bp = f"{pre}.branches.{b}.{k}"
                y = convbn(st, f"{bp}.conv1", xs[b], 1, True)
                y = convbn(st, f"{bp}.conv2", y, 1)
                xs[b] = F.relu(r(y + xs[b]))
        out = []
        for i in range(len(xs)):
            y = None
            for j, xj in enumerate(xs):
                if j == i:
                    t = xj
                elif j > i:
                    t = _upsample(convbn(st, f"{pre}.fuse.{i}.{j}", xj, 1),
                                  2 ** (j - i))
                else:
                    t = xj
                    for k in range(i - j):
                        t = convbn(st, f"{pre}.fuse.{i}.{j}.{k}", t, 2,
                                   k < i - j - 1)
                y = t if y is None else r(y + t)
            out.append(F.relu(y))
        return tuple(out)

    def head(st, *xs):
        y = bottleneck(st, "backbone.incre.0", xs[0])
        for i in range(1, len(xs)):
            y = r(bottleneck(st, f"backbone.incre.{i}", xs[i])
                  + convbn(st, f"backbone.down.{i - 1}", y, 2, True))
        return convbn(st, "backbone.final", y, 1, True)

    x = seg(lambda st, x: convbn(st, "backbone.stem.0", x, 2, True), x)
    x = seg(lambda st, x: convbn(st, "backbone.stem.1", x, 2, True), x)
    for i in range(m["stage1_blocks"]):
        x = seg(lambda st, x, i=i: bottleneck(st, f"backbone.layer1.{i}", x),
                x)
    xs = seg(lambda st, x: (convbn(st, "backbone.transition1.0", x, 1, True),
                            convbn(st, "backbone.transition1.1", x, 2, True)),
             x)
    for pre, widths in _stages(m):
        if len(widths) > len(xs):
            t = f"backbone.transition{len(widths) - 1}"
            xs = xs + (seg(lambda st, x, t=t: convbn(st, t, x, 2, True),
                           xs[-1]),)
        xs = seg(lambda st, *a, pre=pre: module(st, pre, *a), *xs)
    y = seg(head, *xs)
    y = F.leaky_relu(convbn(stats, "head.block", y, 1),
                     m["head_leaky_slope"])
    y = r(_conv(y, p["head.out.weight"], 1, precision)
          + p["head.out.bias"][:, None, None])
    return y.permute(0, 2, 3, 1).contiguous()
