from ppn_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
    shard_rows,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_rows",
]
