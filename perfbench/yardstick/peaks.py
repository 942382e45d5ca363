"""Data-sheet peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense rates, without sparsity, at the 700 W power limit). The
table is the only source: no environment variable changes a number. A card
it lacks gives no peak, and the shares that need one are left out. The bf16
rate is ``ppn_tpu_torch/bench/suite.py``'s ``DENSE_BF16_TFLOPS`` at commit
6c798b19f2f81ac884339f9f662eb9e6d03a12e7, without its ``PPN_PEAK_TFLOPS``
override."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12},
}


def peak(card: str, key: str) -> Optional[float]:
    return PEAKS.get(card, {}).get(key)
