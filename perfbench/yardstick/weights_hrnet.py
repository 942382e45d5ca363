"""Seeded weights of the PPN model on the HRNet-W32 trunk, by the
reference's names (``reference/hrnet.param_shapes``), drawn as
``weights.seeded`` draws them: one ``torch.Generator`` call on the device
for every convolution at once, each weight scaled to LeCun's variance
1/fan_in and clipped at two deviations; BatchNorm scale 1, bias 0, running
mean 0 and variance 1; the head's output bias the configuration's
``head_bias_init``. ``weights.seeded`` reads the ResNet reference's names,
so its arithmetic is copied here over the HRNet reference's."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference.hrnet import param_shapes


def seeded(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(m)
    convs = [(n, s) for n, (s, kind) in shapes.items() if kind == "conv"]
    total = sum(int(np.prod(s)) for _, s in convs)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in convs:
        size = int(np.prod(s))
        std = (s[1] * s[2] * s[3]) ** -0.5 / 0.87962566103423978
        out[n] = (flat[at:at + size].clamp(-2.0, 2.0) * std).view(s)
        at += size
    fill = {"bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0,
            "bias": m["head_bias_init"]}
    for n, (s, kind) in shapes.items():
        if kind != "conv":
            out[n] = torch.full(s, fill[kind], device=device)
    return out
