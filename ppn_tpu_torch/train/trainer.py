"""Trainer: the orchestration loop (port of ``ppn_tpu/train/trainer.py``)
— train steps over a data-parallel mesh (``cfg.train.mesh_shape`` over the
ranks of the ``torch.distributed`` world; one process needs no process
group), K at a time over a ``DeviceCache`` when ``steps_per_call`` > 1,
JSONL metrics and checkpoints written by the primary rank, periodic PCKh
eval on the primary."""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.ops.parse import People
from ppn_tpu_torch.ops.postprocess import postprocess_batch_fast
from ppn_tpu_torch.parallel import make_mesh, replicate, shard_rows
from ppn_tpu_torch.parallel.multihost import is_primary
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.checkpoint import Checkpointer
from ppn_tpu_torch.utils.logging import MetricLogger


class Trainer:
    def __init__(self, cfg: Config,
                 train_batches: Iterator[Dict],
                 val_dataset=None,
                 logdir: Optional[str] = None,
                 augment: Optional[bool] = None,
                 pretrained: Optional[str] = None,
                 device_cache=None,
                 init_npz: Optional[str] = None,
                 device=None,
                 mesh=None):
        """Runs on ``device`` (``cuda`` unless asked otherwise; under a
        launcher, this rank's card).

        ``mesh``: the data-parallel mesh (``parallel.make_mesh``), built
        from ``cfg.train.mesh_shape`` and ``mesh_axes`` when None. With
        ``(-1,)`` the data axis spans the world; a batch size it does not
        divide raises. ``train_batches`` yields this rank's slice of each
        global batch (``DeviceCache(mesh=)`` gathers it, or
        ``parallel.shard_batch``), as numpy arrays or tensors.
        ``pretrained``: a torchvision-format ResNet ``.pth`` for the
        backbone (``steps.create_train_state``).
        ``device_cache``: a ``data/device_cache.DeviceCache``. With
        ``steps_per_call`` K > 1 it feeds the K-step loop
        (``steps.make_multi_train_step``): K steps per call over (K, B)
        index blocks. A cache built without a mesh is resharded over a
        data group of more than one rank.
        ``init_npz``: an inference snapshot to fine-tune from — parameters
        and BatchNorm statistics loaded, optimizer and schedule fresh. A
        resume from this run's own checkpoints still supersedes it. Every
        rank loads, then rank 0's state is broadcast."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or make_mesh(cfg.train.mesh_shape,
                                      cfg.train.mesh_axes, self.device)
        shard_rows(self.mesh, cfg.train.batch_size)  # raises unless it divides
        self.local_batch = cfg.train.batch_size // self.mesh.size()
        self.primary = is_primary()
        self.batches = train_batches
        self.val_dataset = val_dataset
        self.logger = MetricLogger(logdir if self.primary else None,
                                   stdout=self.primary)
        self.state = st.create_train_state(cfg, device=self.device,
                                           pretrained=pretrained)
        if init_npz:
            from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

            load_npz_into_train_state(cfg, init_npz, self.state)
            print(f"fine-tune init from {init_npz}")
        replicate(self.mesh, self.state)
        self.augment = cfg.data.augment if augment is None else augment
        self.device_cache = device_cache
        self.multi_step = None
        k = cfg.train.steps_per_call
        if device_cache is not None and k > 1:
            axis = cfg.train.mesh_axes[0]
            if self.mesh.size(axis) > 1 and device_cache.mesh is None:
                # the CLI path builds its cache before the mesh exists
                device_cache.reshard(self.mesh, axis)
            self.multi_step = st.make_multi_train_step(
                cfg, augment=self.augment, steps_per_call=k, mesh=self.mesh)
        self.ckpt = Checkpointer(cfg.train.checkpoint_dir)
        if cfg.train.resume:
            step = self.ckpt.restore_latest(self.state)
            if step is not None:
                replicate(self.mesh, self.state)
                print(f"resumed from checkpoint at step {step}")

    @property
    def step(self) -> int:
        return self.state.step

    def _index_blocks(self, batch_size: int, k: int, seed: int):
        """(k, batch_size) int32 index blocks for the K-step loop: shuffled
        epochs (with replacement when the dataset is smaller than a batch),
        the JAX trainer's blocks from the same numpy generator."""
        n = self.device_cache.size
        rng = np.random.default_rng(seed)
        if n < batch_size:
            while True:
                yield rng.integers(0, n, (k, batch_size)).astype(np.int32)
        buf = []
        while True:
            for i in rng.permutation(n)[
                    :n - n % batch_size].reshape(-1, batch_size):
                buf.append(i)
                if len(buf) == k:
                    yield np.stack(buf).astype(np.int32)
                    buf = []

    def _log(self, step: int, terms, imgs: int, t_last: float) -> float:
        """Log the terms and the image rate since ``t_last``; returns now."""
        logs = {k: float(v) for k, v in terms.items()}
        logs["images_per_sec"] = imgs / max(time.time() - t_last, 1e-9)
        self.logger.log(step, logs)
        return time.time()

    def run(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        t = self.cfg.train
        target = num_steps if num_steps is not None else t.num_steps
        terms = {}
        t_last = time.time()
        imgs = 0
        step = self.step
        k = t.steps_per_call
        if self.multi_step is not None and step + k <= target:
            # blocks of K steps; the log, checkpoint and eval cadences fall
            # on the block boundaries, and the tail below K takes the
            # per-step loop
            blocks = self._index_blocks(t.batch_size, k, t.seed + step)
            while step + k <= target:
                terms = self.multi_step(self.state, self.device_cache,
                                        next(blocks))
                imgs += t.batch_size * k
                prev, step = step, step + k
                if step // t.log_every > prev // t.log_every:
                    t_last, imgs = self._log(step, terms, imgs, t_last), 0
                if (t.checkpoint_every and step // t.checkpoint_every
                        > prev // t.checkpoint_every):
                    self.ckpt.save(step, self.state)
                if (t.eval_every and self.val_dataset is not None
                        and step // t.eval_every > prev // t.eval_every):
                    self.logger.log(step, self.evaluate())
        while step < target:
            batch = next(self.batches)
            rows = len(batch["image"])
            if self.mesh.size() > 1 and rows != self.local_batch:
                raise ValueError(
                    f"a batch of {rows} rows on a rank of a {self.mesh.size()}"
                    f"-way data mesh; each rank takes {self.local_batch} of "
                    f"the global {t.batch_size}")
            terms = st.train_step(self.cfg, self.state, batch,
                                  augment=self.augment, mesh=self.mesh)
            imgs += rows * self.mesh.size()
            step += 1
            if step % t.log_every == 0:
                t_last, imgs = self._log(step, terms, imgs, t_last), 0
            if t.checkpoint_every and step % t.checkpoint_every == 0:
                self.ckpt.save(step, self.state)
            if (t.eval_every and self.val_dataset is not None
                    and step % t.eval_every == 0):
                self.logger.log(step, self.evaluate())
        if step != self.step:
            raise RuntimeError(f"step mirror {step} != state step {self.step}")
        self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return {k: float(v) for k, v in terms.items()}

    def predict(self, images) -> People:
        """(B, H, W, 3) uint8 or f32 images → host People, through eval-mode
        BatchNorm, the eval (EMA) parameters and ``postprocess_batch_fast``
        (``ppn_post_kernel`` on the card)."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        fm = st.make_forward(self.state)(x)
        return People(*(v.cpu().numpy()
                        for v in postprocess_batch_fast(self.cfg.model, fm)))

    def evaluate(self, max_images: int = 256,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """PCKh@0.5 over (a slice of) the validation set, on the primary
        rank ({} on the others: every rank holds the same parameters)."""
        from ppn_tpu_torch.eval.runner import evaluate_pckh

        if self.val_dataset is None or not self.primary:
            return {}
        return evaluate_pckh(self.cfg, self.predict, self.val_dataset,
                             max_images=max_images, batch_size=batch_size)

    def close(self):
        self.ckpt.close()
        self.logger.close()
