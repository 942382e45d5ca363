"""Device-resident dataset cache (port of ``ppn_tpu/data/device_cache.py``).

The whole collated dataset is uploaded once, images as uint8 (the source
is 8-bit; the augmentation or the model normalizes on the device), and
each batch is gathered on the card from a (B,) index vector. The sampling
order is the JAX class's: the same numpy generators draw the same indices.

Under a data-parallel mesh every rank holds the whole cache, draws the
same global index vector and gathers only its slice of it. The JAX class's
round-robin capacity sharding (``DeviceCache(mesh=)``, ``reshard``), which
pays only once a dataset outgrows one card, is not ported (ROADMAP queue
1, beside the K-step loop).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.data.pipeline import collate
from ppn_tpu_torch.parallel.mesh import shard_rows


def _capacity_guard(device: torch.device, nbytes: int) -> None:
    """Refuse an upload that clearly cannot fit: more than 80% of the
    device's free memory. CPU tensors are not guarded."""
    if device.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(device)
    if nbytes > 0.8 * free:
        raise ValueError(
            f"DeviceCache of {nbytes / 1e9:.2f} GB exceeds 80% of the "
            f"device's {free / 1e9:.2f} GB free memory; stream batches with "
            "data/pipeline.py infinite_batches instead")


class DeviceCache:
    """Holds one collated dataset on ``device`` (``cuda`` unless asked
    otherwise) and yields batches gathered there; under ``mesh`` (a
    ``parallel.Mesh``) each batch is this rank's slice of the global one."""

    def __init__(self, dataset, image_uint8: bool = True, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        n = len(dataset)
        host = collate([dataset[i] for i in range(n)],
                       image_uint8=image_uint8)
        nbytes = sum(v.nbytes for v in host.values())
        _capacity_guard(self.device, nbytes)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in host.items()}
        self.size = n

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """The rows ``idx`` (under a mesh: this rank's slice of them)."""
        idx = np.asarray(idx, np.int64)
        if self.mesh is not None:
            idx = idx[shard_rows(self.mesh, len(idx))]
        i = torch.as_tensor(np.ascontiguousarray(idx), device=self.device)
        return {k: v.index_select(0, i) for k, v in self.data.items()}

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
