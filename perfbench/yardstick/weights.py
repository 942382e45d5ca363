"""Weights the benchmark hands to both sides, by the reference's names
(``reference/model.param_shapes``).

- ``seeded``: drawn on the device from the seed with one ``torch.Generator``
  call for every convolution at once, each weight scaled to LeCun's
  variance 1/fan_in and clipped at two deviations; BatchNorm scale 1, bias
  0, running mean 0 and variance 1; the head's output bias the
  configuration's ``head_bias_init``.
- ``load_snapshot``: an inference snapshot (``.npz`` of ``leaf_{i:04d}``
  float16 arrays in the flatten order of the JAX model's state: keys sorted
  at every level, ``params`` before ``rest``, HWIO kernels), the leaf-order
  arithmetic frozen from ``ppn_tpu_torch/utils/params_io.py`` at commit
  6c798b19f2f81ac884339f9f662eb9e6d03a12e7.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

from perfbench.reference.model import param_shapes

_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("rest", "mean"), "running_var": ("rest", "var")}


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


def _jax_path(name: str):
    """(JAX leaf path, is an HWIO kernel) of a reference name."""
    *mod, leaf = name.split(".")
    parts = tuple(int(p) if p.isdigit() else p for p in mod)
    if mod[-1] == "bn":
        col, key = _BN_LEAF[leaf]
        return (col,) + parts + (key,), False
    if leaf == "weight":
        return ("params",) + parts + ("kernel",), True
    return ("params",) + parts + ("bias",), False


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_snapshot(m: dict, path: str, device) -> Dict[str, torch.Tensor]:
    """The snapshot's leaves as float32 tensors on ``device`` by name; a
    wrong leaf count or shape raises."""
    shapes = param_shapes(m)
    specs = sorted((_jax_path(n) + (n,) for n in shapes),
                   key=lambda s: s[0])
    with np.load(path) as z:
        leaves = [z[k] for k in sorted(z.files)]
    if len(leaves) != len(specs):
        raise ValueError(f"{path} holds {len(leaves)} leaves, the "
                         f"configuration has {len(specs)}")
    out = {}
    for leaf, (_, is_kernel, name) in zip(leaves, specs):
        a = np.asarray(leaf, np.float32)
        if is_kernel:
            a = a.transpose(3, 2, 0, 1)
        if a.shape != tuple(shapes[name][0]):
            raise ValueError(f"leaf for {name} has shape {a.shape}, "
                             f"expected {shapes[name][0]}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
