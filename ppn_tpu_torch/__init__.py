"""ppn_tpu_torch — the Pose Proposal Network in PyTorch for NVIDIA Hopper.

A port of ``ppn_tpu`` (JAX/Pallas on a TPU) that imports nothing of it. Its
paths: batched inference (uint8 images → ResNet trunk + PPN head, cuDNN
convs → one fused post-process CUDA kernel → fixed-shape ``People``),
training (on-device augmentation through an affine-warp CUDA kernel →
target encoding → bf16 forward/backward → SGD + EMA, checkpoints) and
evaluation (PCKh and COCO OKS AP over batches through the post-process
kernel, the evaluate CLI); JPEG files decode on the host in a native
libjpeg pool (``native/``). Entry points run on ``cuda`` unless the caller
asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch


_CONSTANTS: dict = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small read-only tensor of ``values`` on ``device``, made once per
    process: made from host values at each call, it would be an upload
    that waits on the stream, which a CUDA graph cannot capture."""
    key = (tuple(values), dtype, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return _CONSTANTS[key]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) but absent —
    there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ppn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
