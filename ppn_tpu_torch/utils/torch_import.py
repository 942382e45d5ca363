"""torchvision ResNet weights into the port's backbone (counterpart of
``ppn_tpu/utils/torch_import.py``).

The reference model starts from ImageNet-pretrained torchvision weights.
Nothing is downloaded: ``load_torch_resnet_file`` reads a torchvision-
format ``state_dict`` the user supplies (``--pretrained``) and maps it by
name onto ``nn/resnet.py``'s modules:

    conv1 / bn1                      → stem.conv / stem.bn
    layer{s}.{i}.conv{k} / bn{k}     → blocks.<flat>.conv{k}.conv / .bn
    layer{s}.{i}.downsample.{0,1}    → blocks.<flat>.proj.conv / .bn

Both sides hold convolutions as OIHW and BatchNorm as ``weight``,
``bias``, ``running_mean`` and ``running_var``, so nothing is transposed.
``num_batches_tracked`` and the ``fc`` classifier are dropped.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch

from ppn_tpu_torch.nn.resnet import ConvBN, ResNet

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _pairs(backbone: ResNet, keys) -> Iterator[tuple[ConvBN, str, str]]:
    """(ConvBN, torchvision conv prefix, BatchNorm prefix) for every pair of
    the backbone that ``keys`` provide a block for, in order: the stem,
    then each torchvision block ``layer{s}.{i}`` on the next flat block
    (every ConvBN of that block). Raises on a block whose topology the
    backbone's does not match."""
    yield backbone.stem, "conv1", "bn1"
    flat = 0
    for stage in range(1, 5):
        i = 0
        while (f"layer{stage}.{i}.conv1.weight" in keys
               and flat < len(backbone.blocks)):
            pre, block = f"layer{stage}.{i}", backbone.blocks[flat]
            if f"{pre}.conv3.weight" in keys and not hasattr(block, "conv3"):
                raise ValueError(
                    f"{pre} is a bottleneck but block {flat} of the "
                    "backbone is basic — topology mismatch")
            if f"{pre}.downsample.0.weight" in keys and block.proj is None:
                raise ValueError(
                    f"{pre} has a downsample but block {flat} of the "
                    "backbone has no projection — topology mismatch")
            for k in (1, 2, 3):
                if hasattr(block, f"conv{k}"):
                    yield (getattr(block, f"conv{k}"), f"{pre}.conv{k}",
                           f"{pre}.bn{k}")
            if block.proj is not None:
                yield block.proj, f"{pre}.downsample.0", f"{pre}.downsample.1"
            flat += 1
            i += 1


def _count_blocks(keys) -> int:
    return sum(1 for k in keys if k.startswith("layer")
               and k.endswith(".conv1.weight"))


@torch.no_grad()
def load_torch_resnet(backbone: ResNet, state_dict: Mapping[str, torch.Tensor],
                      strict: bool = True) -> int:
    """Copy a torchvision ResNet-18/34/50 ``state_dict`` into ``backbone``
    in place (bottleneck blocks are detected by a ``conv3`` key). Returns
    the number of tensors consumed. ``strict`` raises when the dict's
    block count differs from the backbone's or a tensor is left unused;
    a missing key or a shape mismatch always raises."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")
          and not k.startswith("fc.")}
    used = 0
    for cb, conv, bn in _pairs(backbone, sd):
        targets = [(f"{conv}.weight", cb.conv.weight)] + [
            (f"{bn}.{f}", getattr(cb.bn, f)) for f in _BN_FIELDS]
        for key, dst in targets:
            if key not in sd:
                raise ValueError(f"state_dict lacks {key}")
            src = sd[key]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key} is {tuple(src.shape)}, the backbone "
                                 f"expects {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
            used += 1
    blocks = _count_blocks(sd)
    if blocks != len(backbone.blocks):
        msg = (f"state_dict provides {blocks} blocks, backbone has "
               f"{len(backbone.blocks)}")
        if strict:
            raise ValueError(msg)
        print("warning:", msg)
    if strict and used != len(sd):
        raise ValueError(
            f"consumed {used} tensors but state_dict has {len(sd)}")
    return used


def load_torch_resnet_file(backbone: ResNet, path: str) -> int:
    """Load a ``.pth`` torchvision checkpoint (a ``state_dict``, or a dict
    holding one under ``state_dict``) into ``backbone``, strictly."""
    if not isinstance(backbone, ResNet):
        raise ValueError(f"torchvision ResNet weights need a ResNet backbone, "
                         f"not {type(backbone).__name__}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return load_torch_resnet(backbone, obj)


def torchvision_state_dict(backbone: ResNet) -> dict[str, torch.Tensor]:
    """The backbone's weights and BatchNorm statistics under torchvision's
    names (no ``fc``, no ``num_batches_tracked``): what
    ``load_torch_resnet`` reads back exactly."""
    blocks = {f"layer{stage}.{i}.conv1.weight"
              for stage, n in enumerate(backbone.stage_sizes, start=1)
              for i in range(n)}
    sd = {}
    for cb, conv, bn in _pairs(backbone, blocks):
        sd[f"{conv}.weight"] = cb.conv.weight.detach().cpu().clone()
        for f in _BN_FIELDS:
            sd[f"{bn}.{f}"] = getattr(cb.bn, f).detach().cpu().clone()
    return sd
