"""Structured metrics logging (a copy of ``ppn_tpu/utils/logging.py``
``MetricLogger``): stdout plus JSONL, with the loss terms under the JAX
package's names so that curves compare side by side, and with
``tensorboard=True`` TensorBoard scalars under ``<logdir>/tb/<name>/``
(``utils/tb_events.py``, which needs no TensorFlow)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, logdir: Optional[str] = None, stdout: bool = True,
                 name: str = "train", tensorboard: bool = False):
        self.stdout = stdout
        self._fh = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._fh = open(os.path.join(logdir, f"{name}_metrics.jsonl"),
                            "a", buffering=1)
            if tensorboard:
                from ppn_tpu_torch.utils.tb_events import EventFileWriter

                self._tb = EventFileWriter(os.path.join(logdir, "tb", name))
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, metrics)
        if self.stdout:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("time",))
            print(f"[{rec['time']:9.1f}s] {parts}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
