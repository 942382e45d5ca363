"""Ahead-of-time export of the inference pipeline (counterpart of
``ppn_tpu/utils/export.py``, ``torch.export`` in place of ``jax.export``).

The whole pipeline — normalize, the model with its eval (EMA) parameters
and BatchNorm statistics, decode, NMS and the limb parse — is exported
once for one batch size and device, serialized to bytes, and can be
reloaded and called in any process without the model code, a checkpoint
or a trace:

    from ppn_tpu_torch.utils.export import export_pipeline, load_pipeline
    blob = export_pipeline(cfg, model, batch=8)
    open("ppn.pt2", "wb").write(blob)
    ...
    run = load_pipeline(open("ppn.pt2", "rb").read())
    kp_box, kp_score, valid = run(images)        # (8, H, W, 3) f32

The post-process is the plain PyTorch one with NMS in its bounded form
(``ops/nms.nms_batch(bounded=True)``), as the reference exports the XLA
formulation and not its TPU kernel: a CUDA kernel launched through ctypes
cannot enter an exported graph.
"""

from __future__ import annotations

import io
from typing import Callable

import torch
from torch import nn

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain


class _Pipeline(nn.Module):
    def __init__(self, cfg: Config, model: nn.Module):
        super().__init__()
        self.cfg, self.model = cfg.model, model

    def forward(self, images: torch.Tensor):
        p = postprocess_batch_plain(self.cfg, self.model(images),
                                    bounded=True)
        return p.kp_box, p.kp_score, p.valid


def export_pipeline(cfg: Config, model, batch: int = 8,
                    device=None) -> bytes:
    """The serialized pipeline for f32 ``(batch, H, W, 3)`` images in [0, 1]
    on ``device`` (``cuda`` unless asked otherwise). ``model`` is a
    ``PoseProposalNet`` (exported in eval mode as it is) or a
    ``train/steps.TrainState`` (its eval model: the EMA parameters when
    tracked, as ``Predictor`` uses them). Export failures raise."""
    from ppn_tpu_torch.train.steps import TrainState, eval_model

    dev = resolve_device(device)
    if isinstance(model, TrainState):
        model = eval_model(model)
    pipeline = _Pipeline(cfg, model.eval()).to(dev)
    spec = torch.zeros((batch, *cfg.model.insize, 3), dtype=torch.float32,
                       device=dev)
    with torch.no_grad():
        exported = torch.export.export(pipeline, (spec,))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_pipeline(blob: bytes) -> Callable:
    """Deserialize an exported pipeline into ``run(images) -> (kp_box,
    kp_score, valid)`` for float images in [0, 1] (uint8 raises: the graph
    was traced for floats and would not scale them). It runs on the device
    the artifact was exported for: numpy images are uploaded there, and a
    tensor on another device raises (the model is never moved)."""
    exported = torch.export.load(io.BytesIO(blob))
    dev = next(iter(exported.state_dict.values())).device
    module = exported.module()

    def run(images):
        x = torch.as_tensor(images)
        if not x.is_floating_point():
            raise ValueError(f"images are {x.dtype}; the exported pipeline "
                             "takes float images in [0, 1]")
        if isinstance(images, torch.Tensor) and x.device != dev:
            raise ValueError(f"images on {x.device}; the pipeline was "
                             f"exported for {dev}")
        with torch.no_grad():
            return module(x.to(dev, torch.float32))

    return run
