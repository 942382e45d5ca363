"""High-level inference API (port of ``ppn_tpu/inference.py``).

    from ppn_tpu_torch.inference import Predictor
    p = Predictor.from_npz("mpii_r18_384", "artifacts/mpii_hero_r5_ema_f16.npz")
    people = p.predict(images)          # (B, H, W, 3) uint8 or f32 [0,1]
    people0 = p.predict_single(image)   # (H, W, 3)

Runs the model and the fused post-process on ``cuda`` unless the caller
asks for ``device="cpu"``; returns host ``People`` of numpy arrays.
Flip-TTA is a later slice.
"""

from __future__ import annotations

import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config, get_config
from ppn_tpu_torch.ops import postprocess as post
from ppn_tpu_torch.ops.parse import People


class Predictor:
    def __init__(self, cfg: Config, model: torch.nn.Module, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)

    @classmethod
    def from_npz(cls, config: str | Config, path: str,
                 device=None) -> "Predictor":
        """A predictor over a committed inference snapshot (.npz)."""
        from ppn_tpu_torch.utils.params_io import load_inference_npz

        cfg = get_config(config) if isinstance(config, str) else config
        return cls(cfg, load_inference_npz(cfg, path, device=device),
                   device=device)

    def predict(self, images) -> People:
        """(B, H, W, 3) float32 [0,1] or uint8, at cfg insize → host People."""
        if images.ndim != 4:
            raise ValueError(f"expected (B, H, W, 3), got {images.shape}")
        if tuple(images.shape[1:3]) != tuple(self.cfg.model.insize):
            raise ValueError(
                f"images are {tuple(images.shape[1:3])}, config expects "
                f"{self.cfg.model.insize}; resize first")
        x = torch.as_tensor(images)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        ppl = post.forward_postprocess_fast(self.cfg.model, self.model, x,
                                            device=self.device)
        return People(*(t.cpu().numpy() for t in ppl))

    def predict_single(self, image) -> People:
        return People(*(t[0] for t in self.predict(image[None])))
