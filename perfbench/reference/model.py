"""The plain reference of the PPN model: a ResNet trunk (He et al. 2016,
basic or bottleneck blocks) and the PPN head (Sekii, ECCV 2018), written
as functions of a dictionary of float32 tensors, from a configuration
file's ``model`` group.

It imports nothing of the program. Parameter names follow the
configuration's module tree (``backbone.stem.conv.weight``,
``backbone.blocks.<i>.conv1.bn.weight``, ``head.out.bias``, ...), so that
the benchmark hands one dictionary of weights to both sides.

Conventions the configuration states: NHWC images, uint8 or float in
[0, 1], normalized by the ImageNet mean and deviation; TensorFlow's
``SAME`` padding (asymmetric on stride 2); BatchNorm with momentum 0.9 and
eps 1e-5, the biased batch variance in training and in the running
update; a 3x3 ConvBN and LeakyReLU(0.1) then a 1x1 conv with bias in the
head. The output is the (B, H', W', C) float32 feature map.

``precision`` other than ``"float32"`` rounds every tensor where the
configuration computes in its lower precision: each convolution's input,
weight and output, each BatchNorm's output, each residual sum, the
normalized images and the feature map; in the backward, the gradient
flowing into each of those points. ``"fp8"``, the control, rounds to
float8 (e4m3 forward, e5m2 backward, each by a per-tensor scale to the
format's largest value), the step below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def num_channels(m: dict) -> int:
    K1 = len(m["keypoint_names"])
    hl, wl = m["local_grid_size"]
    return 6 * K1 + len(m["edges"]) * hl * wl


def _blocks(m: dict) -> List[Tuple[str, int, int, int]]:
    """(prefix, cin, cout, stride) of every residual block."""
    out, cin = [], m["widths"][0]
    exp = 4 if m["block"] == "bottleneck" else 1
    i = 0
    for stage, (n, c) in enumerate(zip(m["stage_sizes"], m["widths"])):
        for j in range(n):
            stride = 2 if (j == 0 and stage > 0) else 1
            out.append((f"backbone.blocks.{i}", cin, c, stride))
            cin = c * exp
            i += 1
    return out


def trunk_out(m: dict) -> int:
    exp = 4 if m["block"] == "bottleneck" else 1
    return m["widths"][-1] * exp


def conv_specs(m: dict) -> List[Tuple[str, int, int, int, int, bool]]:
    """(name, cin, cout, kernel, stride, followed by BatchNorm) of every
    convolution, in forward order."""
    w0 = m["widths"][0]
    specs = [("backbone.stem", 3, w0, m["stem_kernel"], 2, True)]
    for pre, cin, c, s in _blocks(m):
        if m["block"] == "bottleneck":
            cexp = 4 * c
            specs += [(f"{pre}.conv1", cin, c, 1, 1, True),
                      (f"{pre}.conv2", c, c, 3, s, True),
                      (f"{pre}.conv3", c, cexp, 1, 1, True)]
            cout = cexp
        else:
            specs += [(f"{pre}.conv1", cin, c, 3, s, True),
                      (f"{pre}.conv2", c, c, 3, 1, True)]
            cout = c
        if s != 1 or cin != cout:
            specs.append((f"{pre}.proj", cin, cout, 1, s, True))
    hw = m["head_width"]
    specs += [("head.block", trunk_out(m), hw, 3, 1, True),
              ("head.out", hw, num_channels(m), 1, 1, False)]
    return specs


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


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.pad(x, (l, r, t, b), value=value)


class _RoundFP8(torch.autograd.Function):
    """float8 e4m3 forward, e5m2 gradient, each by a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _quantize(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, torch.float8_e5m2)


def _quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` (and its gradient in the backward)."""
    if precision == "fp8":
        return _RoundFP8.apply(x)
    return x


def _conv(x, w, stride, precision):
    k = w.shape[-1]
    x = _pad_same(rounded(x, precision), k, stride)
    return rounded(F.conv2d(x, rounded(w, precision), stride=stride),
                   precision)


def _bn(p: Params, name: str, x: torch.Tensor, train: bool, m: dict,
        stats: Optional[Params]):
    eps = m["bn_eps"]
    w, b = p[f"{name}.bn.weight"], p[f"{name}.bn.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            mom = m["bn_momentum"]
            with torch.no_grad():
                rm, rv = f"{name}.bn.running_mean", f"{name}.bn.running_var"
                stats[rm] = mom * stats[rm] + (1 - mom) * mean.detach()
                stats[rv] = mom * stats[rv] + (1 - mom) * var.detach()
    else:
        mean = p[f"{name}.bn.running_mean"]
        var = p[f"{name}.bn.running_var"]
    mul = torch.rsqrt(var + eps) * w
    return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]


def forward(m: dict, p: Params, images: torch.Tensor, train: bool = False,
            stats: Optional[Params] = None,
            precision: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) uint8 or float images → (B, H', W', C) float32 map.
    ``train``: BatchNorm on the batch's statistics, and the running
    statistics updated into ``stats`` when given."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(m["normalize_mean"], device=x.device)
    std = torch.tensor(m["normalize_std"], device=x.device)
    x = rounded(((x - mean) / std).permute(0, 3, 1, 2), precision)

    def convbn(name, x, stride):
        return rounded(_bn(p, name, _conv(x, p[f"{name}.conv.weight"],
                                          stride, precision),
                           train, m, stats), precision)

    x = F.relu(convbn("backbone.stem", x, 2))
    x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
    for pre, cin, c, s in _blocks(m):
        has_proj = f"{pre}.proj.conv.weight" in p
        skip = convbn(f"{pre}.proj", x, s) if has_proj else x
        if m["block"] == "bottleneck":
            y = F.relu(convbn(f"{pre}.conv1", x, 1))
            y = F.relu(convbn(f"{pre}.conv2", y, s))
            y = convbn(f"{pre}.conv3", y, 1)
        else:
            y = F.relu(convbn(f"{pre}.conv1", x, s))
            y = convbn(f"{pre}.conv2", y, 1)
        x = F.relu(rounded(y + skip, precision))
    y = F.leaky_relu(convbn("head.block", x, 1), m["head_leaky_slope"])
    y = rounded(_conv(y, p["head.out.weight"], 1, precision)
                + p["head.out.bias"][:, None, None], precision)
    return y.permute(0, 2, 3, 1).contiguous()
