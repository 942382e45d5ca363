"""Checkpoint and resume (counterpart of ``ppn_tpu/train/checkpoint.py``).

The JAX package writes Orbax checkpoints, which cannot be read without JAX.
The port writes its own format: one ``torch.save`` of the model (parameters
and BatchNorm statistics), the momentum traces, the EMA, the step and the
generator state, to ``ckpt_{step:08d}.pt`` — a name that no Orbax directory
uses, so that a shared ``checkpoint_dir`` is never misread. Each file is
written to a temporary name and then renamed into place, so a crash leaves
either the old set or the new one. Saves are synchronous.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ppn_tpu_torch.train.steps import TrainState, create_train_state

_NAME = re.compile(r"^ckpt_(\d{8})\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for n in os.listdir(self.directory)
                      if (m := _NAME.match(n)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, step: int, state: TrainState) -> None:
        payload = {
            "step": step,
            "model": state.model.state_dict(),
            "trace": state.trace,
            "ema": state.ema,
            "generator": state.generator.get_state(),
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore_latest(self, state: TrainState) -> Optional[int]:
        """Load the newest checkpoint into ``state`` in place and return its
        step, or None when there is none. When ``ema_decay`` was toggled
        between runs, the state keeps this run's choice, as the JAX trainer
        reconciles it: a saved EMA is dropped when this run tracks none, and
        a run that tracks one seeds it from the restored parameters when the
        checkpoint has none."""
        steps = self._steps()
        if not steps:
            return None
        step = steps[-1]
        dev = state.device
        payload = torch.load(self._path(step), map_location=dev,
                             weights_only=True)
        try:
            state.model.load_state_dict(payload["model"])
            for name, t in payload["trace"].items():
                state.trace[name].copy_(t)
        except (RuntimeError, KeyError) as e:
            raise RuntimeError(
                f"checkpoint at step {step} in {self.directory} does not "
                "match this model; delete it or pass resume=False") from e
        if state.ema is not None:
            src = payload["ema"] or dict(state.model.named_parameters())
            state.ema = {n: t.detach().clone().to(dev)
                         for n, t in src.items()}
        state.step = payload["step"]
        state.generator.set_state(payload["generator"].cpu())
        return step

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""


def load_state(cfg, ckpt_dir: Optional[str] = None,
               device=None) -> TrainState:
    """A ``TrainState`` on ``device`` (``cuda`` unless asked otherwise):
    freshly initialized when ``ckpt_dir`` is None, else restored from the
    newest ``ckpt_*.pt`` in that directory. Raises ``ValueError`` on a
    directory of Orbax checkpoints (the JAX package's format, which the
    port cannot read) and on an inference snapshot (``.npz``, which holds
    no training state: ``Predictor.from_npz`` reads it), and
    ``FileNotFoundError`` when there is no checkpoint."""
    if ckpt_dir and ckpt_dir.endswith(".npz"):
        raise ValueError(
            f"{ckpt_dir} is an inference snapshot, not a training "
            "checkpoint; load it with Predictor.from_npz")
    state = create_train_state(cfg, device=device)
    if not ckpt_dir:
        return state
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if Checkpointer(ckpt_dir).restore_latest(state) is None:
        if any(n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n))
               for n in os.listdir(ckpt_dir)):
            raise ValueError(
                f"{ckpt_dir} holds Orbax checkpoints written by the JAX "
                "package, which the port cannot read; export the weights "
                "with tools/export_snapshot.py and pass the .npz")
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return state
