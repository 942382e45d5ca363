"""Feature map → parsed People (port of ``ppn_tpu/ops/postprocess.py``).

``postprocess_batch_plain`` is decode → NMS → parse in plain PyTorch: the
CPU path, and the version the CUDA kernel is held against on the card.
``postprocess_batch_fast`` launches ``ppn_post_kernel`` for a CUDA tensor and
takes the plain version for a CPU one. The JAX package's batch-size dispatch
between its two TPU kernels has no counterpart: one kernel serves every B.
"""

from __future__ import annotations

import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops import cuda_post
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops import nms as nmsops
from ppn_tpu_torch.ops import parse as parseops
from ppn_tpu_torch.ops.parse import People


def postprocess_batch_plain(cfg: PPNConfig, feature_map: torch.Tensor) -> People:
    """(B, H', W', C) feature map → batched People, plain PyTorch."""
    act, props = dec.decode(cfg, feature_map)
    nms = nmsops.nms_batch(cfg, props)
    return parseops.parse_batch(cfg, act, props, nms)


def postprocess_batch_fast(cfg: PPNConfig, feature_map: torch.Tensor) -> People:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if feature_map.device.type == "cuda":
        return cuda_post.postprocess_batch_cuda(cfg, feature_map)
    if feature_map.device.type == "cpu":
        return postprocess_batch_plain(cfg, feature_map)
    raise ValueError(f"no post-process for device {feature_map.device}")


@torch.no_grad()
def forward_postprocess_fast(cfg: PPNConfig, model, images,
                             device=None) -> People:
    """Model forward + post-process on ``device`` (``cuda`` unless asked
    otherwise); ``images`` (B, H, W, 3) uint8 or f32, array or tensor."""
    dev = resolve_device(device)
    fm = model(torch.as_tensor(images).to(dev))
    return postprocess_batch_fast(cfg, fm)
