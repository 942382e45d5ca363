"""Inference snapshots (.npz) into the port (counterpart of
``ppn_tpu/utils/params_io.py``).

A snapshot holds ``leaf_{i:04d}`` arrays, the leaves of
``jax.tree.flatten({"params": …, "rest": …})`` of the JAX model's NNX state,
float32 stored as float16.

Hazard — leaf order. NNX state flattens with its keys sorted at every level,
block indices as integers in numeric order (``blocks[10]`` after
``blocks[9]``): ``bn`` before ``conv``, ``bias`` before ``scale``, ``proj``
after ``conv2``, ``stem`` after ``blocks``, all ``params`` before all
``rest``. For mpii_r18_384 that is 107 leaves, from
``params.backbone.blocks[0].conv1.bn.bias`` to ``rest.head.block.bn.var``.
``jax_leaf_paths`` rebuilds that order from the port's own modules.

Name map: ``kernel`` HWIO → ``weight`` OIHW (the head's ``(1,1,512,C)`` →
``(C,512,1,1)`` too), ``scale`` → ``weight``, ``mean``/``var`` →
``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.nn.resnet import BatchNorm, Conv

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaf_specs(model: torch.nn.Module):
    """(jax path, state_dict name, is_kernel) per leaf, in JAX flatten order."""
    specs = []
    for name, mod in model.named_modules():
        parts = tuple(int(p) if p.isdigit() else p for p in name.split("."))
        if isinstance(mod, Conv):
            specs.append((("params",) + parts + ("kernel",),
                           f"{name}.weight", True))
            if mod.bias is not None:
                specs.append((("params",) + parts + ("bias",),
                              f"{name}.bias", False))
        elif isinstance(mod, BatchNorm):
            for jax_name, torch_name, col in (
                    ("scale", "weight", "params"), ("bias", "bias", "params"),
                    ("mean", "running_mean", "rest"),
                    ("var", "running_var", "rest")):
                specs.append(((col,) + parts + (jax_name,),
                              f"{name}.{torch_name}", False))
    # every dict level holds keys of one type, so tuple order is JAX's order
    return sorted(specs, key=lambda s: s[0])


def jax_leaf_paths(model: torch.nn.Module) -> list[tuple]:
    """The JAX snapshot's leaf paths, in leaf order, for this model."""
    return [s[0] for s in _leaf_specs(model)]


def state_dict_from_jax_leaves(cfg: Config, leaves: list[np.ndarray],
                               model: torch.nn.Module | None = None
                               ) -> dict[str, torch.Tensor]:
    """The JAX package's flattened parameters → this port's ``state_dict``
    (f32 CPU tensors). Raises ``ValueError`` on a wrong leaf count or shape,
    as the JAX loader does."""
    if model is None:
        model = PoseProposalNet(cfg.model)
    specs = _leaf_specs(model)
    if len(leaves) != len(specs):
        raise ValueError(
            f"snapshot holds {len(leaves)} leaves, this config expects "
            f"{len(specs)} — wrong config for this snapshot?")
    want = model.state_dict()
    out = {}
    for leaf, (path, name, is_kernel) in zip(leaves, specs):
        a = np.asarray(leaf, dtype=np.float32)   # f16 snapshots upcast here
        if is_kernel:
            a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
        if a.shape != tuple(want[name].shape):
            raise ValueError(
                f"leaf {'.'.join(map(str, path))} shape {leaf.shape} does "
                f"not fit {name} {tuple(want[name].shape)}")
        out[name] = torch.tensor(a)
    return out


def load_inference_npz(cfg: Config, path: str,
                       device=None) -> PoseProposalNet:
    """A snapshot as an eval-mode ``PoseProposalNet`` on ``device``
    (``cuda`` unless asked otherwise), computing in ``cfg.train.dtype``."""
    dev = resolve_device(device)
    model = PoseProposalNet(cfg.model, dtype=_DTYPES[cfg.train.dtype])
    with np.load(path) as z:
        leaves = [z[n] for n in sorted(z.files)]
    model.load_state_dict(state_dict_from_jax_leaves(cfg, leaves, model))
    return model.eval().to(dev)
