"""Device-resident dataset cache (port of ``ppn_tpu/data/device_cache.py``).

The whole collated dataset is uploaded once, images as uint8 (the source
is 8-bit; the augmentation or the model normalizes on the device), and
each batch is gathered on the card from a (B,) index vector. The sampling
order is the JAX class's: the same numpy generators draw the same indices.

Under a data-parallel mesh the cache is sharded by capacity: the rows are
padded cyclically to a multiple of the data group's size and rank r holds
the contiguous block ``[r·n_pad/world, (r+1)·n_pad/world)``, the rows
``NamedSharding(P("data"))`` gives device r in the JAX package. Every rank
draws the same global index vector; ``batch`` returns this rank's slice of
the gathered batch, whose rows live on other ranks too, so the gather is
one ``all_gather`` over the group of each rank's rows packed as bytes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.data.pipeline import collate
from ppn_tpu_torch.parallel.mesh import shard_rows


def _capacity_guard(device: torch.device, nbytes: int) -> None:
    """Refuse an upload that clearly cannot fit: more than 80% of the
    device's free memory (under a mesh, this rank's share against this
    rank's card). CPU tensors are not guarded."""
    if device.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(device)
    if nbytes > 0.8 * free:
        raise ValueError(
            f"DeviceCache of {nbytes / 1e9:.2f} GB exceeds 80% of the "
            f"device's {free / 1e9:.2f} GB free memory; shard it over more "
            "ranks (mesh=), or stream batches with data/pipeline.py "
            "infinite_batches instead")


def block_rows(n: int, world: int, rank: int) -> np.ndarray:
    """The dataset rows rank ``rank`` of ``world`` holds: its contiguous
    block of the rows padded cyclically to a multiple of ``world`` (the
    JAX package's ``_pad_rows``: row j of the padded set is row j mod n,
    valid when n < world too)."""
    per = -(-n // world)
    return np.arange(rank * per, (rank + 1) * per) % n


class DeviceCache:
    """Holds one collated dataset on ``device`` (``cuda`` unless asked
    otherwise) and yields batches gathered there; under ``mesh`` (a
    ``parallel.Mesh``) this rank holds its block of rows and each batch is
    this rank's slice of the global one."""

    def __init__(self, dataset, image_uint8: bool = True, device=None,
                 mesh=None, data_axis: str = "data"):
        self.device = resolve_device(device)
        self.size = n = len(dataset)
        self.mesh, self.axis = mesh, data_axis
        world, rank = ((1, 0) if mesh is None else
                       (mesh.size(data_axis), mesh.rank(data_axis)))
        rows = block_rows(n, world, rank)
        if hasattr(dataset, "materialize_collated"):
            # disk-memoized (synthetic renders cost tens of ms a sample);
            # indexing copies this rank's rows out of the read-only memo
            host = {k: v[rows] for k, v in dataset.materialize_collated(
                image_uint8=image_uint8).items()}
        else:
            host = collate([dataset[int(i)] for i in rows],
                           image_uint8=image_uint8)
        _capacity_guard(self.device, sum(v.nbytes for v in host.values()))
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in host.items()}

    def reshard(self, mesh, data_axis: str = "data") -> None:
        """Re-lay a cache built without a mesh over ``mesh``'s data axis in
        place: this rank keeps its block of the cyclically padded rows (the
        Trainer adopts a cache built before its mesh this way); indices
        keep addressing the original ``size`` rows."""
        if self.mesh is not None:
            raise ValueError("the cache is sharded already")
        rows = torch.from_numpy(block_rows(
            self.size, mesh.size(data_axis), mesh.rank(data_axis))).to(
            self.device)
        self.data = {k: v.index_select(0, rows) for k, v in self.data.items()}
        self.mesh, self.axis = mesh, data_axis

    def nbytes(self) -> int:
        """The bytes this rank holds (under a mesh, its block)."""
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def _take(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        i = torch.as_tensor(np.ascontiguousarray(rows, np.int64),
                            device=self.device)
        return {k: v.index_select(0, i) for k, v in self.data.items()}

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """The rows ``idx`` (under a mesh: this rank's slice of them)."""
        idx = np.asarray(idx, np.int64)
        if self.mesh is None:
            return self._take(idx)
        mine = shard_rows(self.mesh, len(idx), self.axis)
        group = self.mesh.group(self.axis)
        if group is None:                   # one rank holds every row
            return self._take(idx[mine])
        return self._gather(idx, mine, group)

    def _gather(self, idx: np.ndarray, mine: slice, group
                ) -> Dict[str, torch.Tensor]:
        """This rank's slice of the rows ``idx`` of the sharded cache: each
        rank packs the rows of ``idx`` it holds (in order, padded to the
        largest owner's count) into one uint8 tensor of their bytes, one
        all_gather brings every rank's to every rank, and this rank unpacks
        the rows of its slice. Bytes are copied, never summed. The fields
        are packed in the order of their names, which every rank shares
        whatever order its own dict was filled in."""
        world, rank = self.mesh.size(self.axis), self.mesh.rank(self.axis)
        per = len(next(iter(self.data.values())))
        owner = idx // per
        slot = np.empty(len(idx), np.int64)
        counts = np.zeros(world, np.int64)
        for o in range(world):
            at = np.flatnonzero(owner == o)
            slot[at], counts[o] = np.arange(len(at)), len(at)
        held = self._take(idx[owner == rank] - rank * per)
        names = sorted(self.data)
        widths = [math.prod(self.data[k].shape[1:])
                  * self.data[k].element_size() for k in names]
        m = int(counts.max())
        packed = torch.zeros((m, sum(widths)), dtype=torch.uint8,
                             device=self.device)
        if counts[rank]:
            packed[:int(counts[rank])] = torch.cat(
                [held[k].reshape(len(held[k]), -1).view(torch.uint8)
                 for k in names], 1)
        parts = [torch.empty_like(packed) for _ in range(world)]
        dist.all_gather(parts, packed, group=group)
        flat = torch.stack(parts).reshape(world * m, -1)
        at = torch.as_tensor(owner[mine] * m + slot[mine], device=self.device)
        rows = flat.index_select(0, at)
        out, col = {}, 0
        for k, width in zip(names, widths):
            v = self.data[k]
            out[k] = rows[:, col:col + width].clone().view(
                v.dtype).reshape(len(rows), *v.shape[1:])
            col += width
        return {k: out[k] for k in self.data}

    def epoch_shuffled_batches(self, batch_size: int, *, seed: int = 0
                               ) -> Iterator[Dict[str, torch.Tensor]]:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.size)
        for i in range(0, self.size - batch_size + 1, batch_size):
            yield self.batch(idx[i:i + batch_size])

    def infinite_batches(self, batch_size: int, *, seed: int = 0
                         ) -> Iterator[Dict[str, torch.Tensor]]:
        """Shuffled epochs forever; a dataset smaller than one batch is
        sampled with replacement (the overfit path)."""
        if self.size < batch_size:
            rng = np.random.default_rng(seed)
            while True:
                yield self.batch(rng.integers(0, self.size, batch_size))
        epoch = 0
        while True:
            yield from self.epoch_shuffled_batches(batch_size,
                                                   seed=seed + epoch)
            epoch += 1
