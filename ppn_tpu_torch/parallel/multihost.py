"""Joining a multi-process world (counterpart of
``ppn_tpu/parallel/multihost.py``).

``initialize`` joins the ``torch.distributed`` process group (NCCL for
CUDA ranks, gloo for CPU ones), ``is_primary`` names the rank that writes
checkpoints and logs, and ``global_batch_from_local`` checks that every
rank contributes the same number of rows. The rules are the JAX
package's: a configured cluster that cannot be joined raises, and only a
bare single-host run, where no launcher configured anything, goes on as
one process.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ppn_tpu_torch.parallel.mesh import Mesh


def _int_env(name: str) -> int:
    return int(os.environ.get(name, "1") or 1)


def _cluster_configured() -> bool:
    """Whether a launcher configured a multi-process world: a coordinator
    address, a SLURM multi-task allocation, an OpenMPI or PMI world (the
    JAX package's rules), or a torchrun world of more than one rank."""
    return (any(os.environ.get(k) for k in
                ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
            or _int_env("SLURM_NTASKS") > 1
            or _int_env("OMPI_COMM_WORLD_SIZE") > 1
            or _int_env("PMI_SIZE") > 1
            or (_int_env("WORLD_SIZE") > 1
                and bool(os.environ.get("MASTER_ADDR"))))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group; ``backend`` defaults to ``nccl`` when CUDA is
    present and ``gloo`` otherwise (pass ``gloo`` for CPU ranks).

    With explicit arguments (``host:port``, the world size, this rank)
    every failure raises. Without them the world comes from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``, as torchrun sets them); if that fails while a launcher
    configured a cluster (``_cluster_configured``), it raises too — ranks
    silently training alone on the same seed, overwriting one another's
    checkpoints, is the fault this guards against. Only the bare
    single-host case is a no-op, and so is a call in a process that has
    already joined."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None or num_processes is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit cluster needs num_processes and "
                             "process_id besides the coordinator address")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not a rank of a "
                             f"world of {num_processes}")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        return
    configured = _cluster_configured()
    try:
        dist.init_process_group(backend, init_method="env://")
    except (ValueError, RuntimeError):
        if configured:
            raise
        # no launcher configured a world: one process, nothing to join


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs (rank 0, or the
    only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_batch_from_local(mesh: Mesh, local_batch: Dict
                            ) -> Dict[str, torch.Tensor]:
    """The rank's rows of the global batch, on its device. In JAX this
    assembles per-host shards into one global array; here each rank keeps
    only its rows, so what remains is the check that every rank holds the
    same number of them (one all-reduce of the counts; a mismatch
    raises)."""
    counts = {len(v) for v in local_batch.values()}
    if len(counts) != 1:
        raise ValueError(f"local batch leaves disagree on rows: {counts}")
    n = counts.pop()
    group = mesh.group()
    if group is not None:
        span = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(span, op=dist.ReduceOp.MAX, group=group)
        if int(span[0]) != -int(span[1]):
            raise ValueError(f"ranks hold between {-int(span[1])} and "
                             f"{int(span[0])} rows; each must hold the same")
    return {k: torch.as_tensor(v).to(mesh.device)
            for k, v in local_batch.items()}
