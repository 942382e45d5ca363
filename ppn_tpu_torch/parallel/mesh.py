"""Data-parallel mesh over a ``torch.distributed`` world (counterpart of
``ppn_tpu/parallel/mesh.py``).

The JAX package shards the batch over a named ``data`` axis and lets XLA
emit the gradient all-reduce under ``jit``. Here every process is one rank
holding one device: the mesh is a ``DeviceMesh`` over the world's ranks, a
rank keeps its contiguous slice of each global batch (the rows
``NamedSharding(P("data"))`` would give its device), the parameters are
replicated from rank 0, and the step reduces explicitly over the data
group (``train/steps.py``; BatchNorm's statistics in ``nn/resnet.py``).

A mesh of one rank needs no process group: it is a ``Mesh`` with no
``DeviceMesh``, and every collective is skipped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh's shape and axis names, the device this rank computes on,
    and the ``DeviceMesh`` over the world (None for one rank and no
    process group)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device
    device_mesh: Optional[Any] = None

    def size(self, axis: str = "data") -> int:
        return self.shape[self.axis_names.index(axis)]

    def rank(self, axis: str = "data") -> int:
        """This process's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str = "data"):
        """The process group along ``axis`` through this rank, or None
        when there is no process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """A mesh over every rank of the world (one rank when no process group
    is initialized); a single -1 absorbs the ranks the other axes leave.
    ``device`` is this rank's (``cuda`` unless asked otherwise). Raises
    when the shape does not cover the world exactly: a torchrun world is
    fixed by the launcher, and an idle rank would be a silent fault."""
    from ppn_tpu_torch import resolve_device

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = [int(s) for s in mesh_shape]
    if len(shape) != len(axis_names) or shape.count(-1) > 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} does not fit the "
                         f"axes {tuple(axis_names)} (at most one -1)")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world or min(shape) < 1:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} -> {tuple(shape)} "
                         f"does not cover the world of {world} ranks")
    shape, names = tuple(shape), tuple(axis_names)
    if not dist.is_initialized():
        return Mesh(shape, names, dev)
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(shape, names, dev,
                init_device_mesh(dev.type, shape, mesh_dim_names=names))


def shard_rows(mesh: Mesh, n: int, axis: str = "data") -> slice:
    """This rank's contiguous rows of a global batch of ``n``. Raises when
    the data axis does not divide ``n``, as JAX's sharding refuses it."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"a batch of {n} does not divide over the {size} "
                         f"ranks of the {axis!r} axis")
    per = n // size
    r = mesh.rank(axis)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh: Mesh, batch: dict, axis: str = "data") -> dict:
    """This rank's slice of every leaf's leading dimension (arrays or
    tensors, left where they are)."""
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch leaves disagree on the leading dim: {n}")
    rows = shard_rows(mesh, n.pop(), axis)
    return {k: v[rows] for k, v in batch.items()}


def replicate(mesh: Mesh, obj):
    """Broadcast, in place, every tensor of ``obj`` from rank 0 to the whole
    mesh and return ``obj``: a module's parameters and buffers, or a
    ``TrainState``'s model, momentum traces and EMA. The augmentation
    generator is not sent: every rank seeds it alike and restores it from
    the same checkpoint."""
    if mesh.device_mesh is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    else:                                   # a train/steps.TrainState
        tensors = [*obj.model.parameters(), *obj.model.buffers(),
                   *obj.trace.values(), *(obj.ema or {}).values()]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return obj


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its gradient is the sum over the group of
    the incoming gradients, so the gradient of every rank's loss reaches
    every rank's inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiably."""
    return _AllReduceSum.apply(x, group)
