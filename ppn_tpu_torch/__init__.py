"""ppn_tpu_torch — the Pose Proposal Network in PyTorch for NVIDIA Hopper.

A port of ``ppn_tpu`` (JAX/Pallas on a TPU) that imports nothing of it. Its
paths: batched inference (uint8 images → ResNet trunk + PPN head, cuDNN
convs → one fused post-process CUDA kernel → fixed-shape ``People``) and
training (on-device augmentation through an affine-warp CUDA kernel →
target encoding → bf16 forward/backward → SGD + EMA, checkpoints, PCKh
eval through the post-process kernel). Entry points run on ``cuda`` unless
the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch


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
