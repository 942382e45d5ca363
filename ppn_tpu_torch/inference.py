"""High-level inference API (port of ``ppn_tpu/inference.py``).

    from ppn_tpu_torch.inference import Predictor
    p = Predictor.from_npz("mpii_r18_384", "artifacts/mpii_hero_r5_ema_f16.npz")
    people = p.predict(images)          # (B, H, W, 3) uint8 or f32 [0,1]
    people0 = p.predict_single(image)   # (H, W, 3)

Runs the model and the fused post-process on ``cuda`` unless the caller
asks for ``device="cpu"``; returns host ``People`` of numpy arrays. With
``flip_tta`` the model also runs on the mirrored images, the two maps merge
in logit space in f32 (``ops/tta.py``), and one post-process reads the
merged map.
"""

from __future__ import annotations

from typing import Optional

import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config, get_config
from ppn_tpu_torch.ops import postprocess as post
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.ops.tta import flip_tta_forward


def fetch_async(people: People) -> tuple[People, Optional[torch.cuda.Event]]:
    """Start copying device ``People`` to host memory without waiting: the
    copies (pinned, on the current stream) and an event that completes
    when they have arrived. CPU tensors are returned as they are, with no
    event."""
    if people.valid.device.type != "cuda":
        return people, None
    host = People(*(t.to("cpu", non_blocking=True) for t in people))
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait_host(host: People, event: Optional[torch.cuda.Event]) -> People:
    """``fetch_async``'s copies as numpy arrays, once they have arrived."""
    if event is not None:
        event.synchronize()
    return People(*(t.numpy() for t in host))


class Predictor:
    def __init__(self, cfg: Config, model: torch.nn.Module, device=None,
                 flip_tta: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.eval().to(self.device)
        self.flip_tta = flip_tta

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_npz(cls, config: str | Config, path: str, device=None,
                 flip_tta: bool = False) -> "Predictor":
        """A predictor over a committed inference snapshot (.npz)."""
        from ppn_tpu_torch.utils.params_io import load_inference_npz

        cfg = get_config(config) if isinstance(config, str) else config
        return cls(cfg, load_inference_npz(cfg, path, device=device),
                   device=device, flip_tta=flip_tta)

    @classmethod
    def from_checkpoint(cls, config: str | Config,
                        ckpt_dir: Optional[str] = None,
                        flip_tta: bool = False, device=None) -> "Predictor":
        """A predictor over a snapshot (``.npz``, as ``from_npz``), the
        newest of the port's own checkpoints in a directory (``ckpt_*.pt``,
        eval parameters: the EMA when tracked), or a fresh init (``None``);
        ``train/checkpoint.load_state`` says what it raises."""
        from ppn_tpu_torch.train.checkpoint import load_state
        from ppn_tpu_torch.train.steps import eval_model

        cfg = get_config(config) if isinstance(config, str) else config
        if ckpt_dir and ckpt_dir.endswith(".npz"):
            return cls.from_npz(cfg, ckpt_dir, device=device,
                                flip_tta=flip_tta)
        state = load_state(cfg, ckpt_dir, device=device)
        return cls(cfg, eval_model(state), device=device, flip_tta=flip_tta)

    # ---- inference ---------------------------------------------------------
    @torch.no_grad()
    def _run(self, images: torch.Tensor) -> People:
        """(B, H, W, 3) uint8 or f32 images on the predictor's device →
        batched ``People`` there. Enqueues the work and returns without
        waiting for it."""
        m = self.cfg.model
        if not self.flip_tta:
            return post.forward_postprocess_fast(m, self.model, images,
                                                 device=self.device)
        return post.postprocess_batch_fast(
            m, flip_tta_forward(m, self.model, images))

    def predict(self, images) -> People:
        """(B, H, W, 3) float32 [0,1] or uint8, at cfg insize → host People."""
        if images.ndim != 4:
            raise ValueError(f"expected (B, H, W, 3), got {images.shape}")
        if tuple(images.shape[1:3]) != tuple(self.cfg.model.insize):
            raise ValueError(
                f"images are {tuple(images.shape[1:3])}, config expects "
                f"{self.cfg.model.insize}; resize first "
                "(ppn_tpu_torch.ops.image.resize_bilinear)")
        x = torch.as_tensor(images)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        return wait_host(*fetch_async(self._run(x.to(self.device))))

    def predict_single(self, image) -> People:
        return People(*(t[0] for t in self.predict(image[None])))
