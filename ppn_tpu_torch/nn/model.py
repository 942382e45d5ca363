"""PoseProposalNet: backbone + dense grid head (port of ``ppn_tpu/nn/model.py``).

Head: one ConvBN 3×3 + LeakyReLU(0.1) on the backbone feature, then a 1×1
conv with bias to ``6(K+1) + H_l·W_l·L`` channels. The output is the f32 NHWC
feature map ``(B, H', W', C)`` the JAX model returns, whatever the compute
dtype.

``packed_feature`` (the JAX model's transposed head GEMM) is not ported: it
lays the head out in the TPU packed kernel's lanes and carries no semantics.
The Hopper post-process kernel reads this NHWC map directly.
"""

from __future__ import annotations

import torch
from torch import nn

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.nn.hrnet import HRNet
from ppn_tpu_torch.nn.resnet import Conv, ConvBN, resnet18, resnet34, resnet50

_BACKBONES = {"resnet18": resnet18, "resnet34": resnet34,
              "resnet50": resnet50, "hrnet_w32": HRNet}
# TrainConfig.dtype → compute dtype
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class PPNHead(nn.Module):
    def __init__(self, cfg: PPNConfig, cin: int, dtype=torch.bfloat16):
        super().__init__()
        self.block = ConvBN(cin, 512, 3, 1, dtype, act="leaky_relu")
        self.out = Conv(512, cfg.num_channels, 1, bias=True, dtype=dtype)
        # start resp/conf σ-scores low (YOLO-style init), as the JAX head
        nn.init.constant_(self.out.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.block(x))


class PoseProposalNet(nn.Module):
    """images (B, H, W, 3) uint8 or f32 in [0,1] → feature map (B, H', W', C) f32."""

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self, cfg: PPNConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        if cfg.backbone not in _BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.backbone = _BACKBONES[cfg.backbone](dtype=dtype)
        self.head = PPNHead(cfg, self.backbone.out_features, dtype=dtype)
        # ImageNet statistics as buffers outside the state dict: made on
        # the host per call, they would be copied with a stream sync
        self.register_buffer("mean", torch.tensor(self.MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(self.STD), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        x = ((images - self.mean.to(images.dtype))
             / self.std.to(images.dtype))                # f32, NHWC
        # NHWC → NCHW view: the memory stays channels_last for cuDNN
        f = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        return self.head(f).permute(0, 2, 3, 1).to(torch.float32).contiguous()


def num_params(model: nn.Module) -> int:
    """The number of trainable values, as the JAX function counts its
    ``nnx.Param``s: BatchNorm's running statistics (buffers here) are not
    parameters. A model built on the meta device costs no memory."""
    return sum(p.numel() for p in model.parameters())
