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
from ppn_tpu_torch.nn.model import DTYPES, PoseProposalNet
from ppn_tpu_torch.nn.resnet import BatchNorm, Conv



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
    model = PoseProposalNet(cfg.model, dtype=DTYPES[cfg.train.dtype])
    with np.load(path) as z:
        leaves = [z[n] for n in sorted(z.files)]
    model.load_state_dict(state_dict_from_jax_leaves(cfg, leaves, model))
    return model.eval().to(dev)


def jax_leaves_from_state_dict(state_dict: dict, model: torch.nn.Module
                               ) -> list[np.ndarray]:
    """The inverse of ``state_dict_from_jax_leaves``: f32 numpy leaves in
    the JAX leaf order, OIHW kernels back to HWIO."""
    leaves = []
    for _, name, is_kernel in _leaf_specs(model):
        a = state_dict[name].detach().to(torch.float32).cpu().numpy()
        leaves.append(a.transpose(2, 3, 1, 0) if is_kernel else a)
    return leaves


def save_inference_npz(path: str, state) -> int:
    """Write a train state's eval parameters (the EMA when tracked) and
    BatchNorm statistics as a snapshot the JAX package loads: leaves
    ``leaf_{i:04d}`` in its order, f32 stored as f16. Returns the number of
    leaves written."""
    from ppn_tpu_torch.train.steps import eval_params

    model = state.model
    sd = {**dict(model.named_buffers()), **eval_params(state)}
    leaves = jax_leaves_from_state_dict(sd, model)
    np.savez_compressed(path, **{f"leaf_{i:04d}": a.astype(np.float16)
                                 for i, a in enumerate(leaves)})
    return len(leaves)


def load_npz_into_train_state(cfg: Config, path: str, state):
    """Fine-tune initialization: a snapshot's parameters and BatchNorm
    statistics into ``state``'s model, the EMA (when tracked) seeded from
    them; the momentum traces, step count and generator stay fresh — a
    fine-tune restarts the schedule. Returns ``state``."""
    model = state.model
    with np.load(path) as z:
        leaves = [z[n] for n in sorted(z.files)]
    model.load_state_dict(state_dict_from_jax_leaves(cfg, leaves, model))
    if state.ema is not None:
        state.ema = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return state
