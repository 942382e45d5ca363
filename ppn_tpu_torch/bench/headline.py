"""The port's one-line headline (counterpart of the root ``bench.py``'s
``run_bench``): device throughput of the flagship inference pipeline.

    python -m ppn_tpu_torch.bench.headline

Runs ``mpii_r18_384`` (the seeded init) at the serving batch
``PPN_BENCH_BATCH`` (default 128) on seeded f32 images held on the card:
the model and one ``ppn_post_kernel`` launch per call. Prints ONE JSON
line: ``metric``, ``value`` (images/s from ``device_batch_ms``, the
back-to-back slope of ``utils/profiling.device_latency_ms``), ``unit``,
``vs_baseline`` (value / 500, BASELINE.json's target), ``batch``,
``mfu_pct`` (the forward's conv and matmul FLOPs, ``flops_source``,
against the card's dense bf16 peak or ``PPN_PEAK_TFLOPS``),
``device_batch_ms``, ``host_loop_images_per_sec`` (the best of 3 host
loops of 30 calls, each ended by a device synchronization) and ``card``.

Any failure raises and the exit code is not 0: no probe, no watchdog, no
retry and no error line.
"""

from __future__ import annotations

import json
import os

from ppn_tpu_torch.bench.suite import (BASELINE_IMAGES_PER_SEC, card,
                                       serving_batch)


def run_bench(config_name="mpii_r18_384", batch=None, device=None) -> dict:
    """Measure, print the headline line and return it as a dict: three
    calls to settle, the best of 3 host loops of 30 calls, then
    ``device_batch_ms`` over 10 and 20 calls (``suite.serving_batch``)."""
    if batch is None:
        batch = int(os.environ.get("PPN_BENCH_BATCH", "128"))
    _cfg, dev, m = serving_batch(config_name, batch, iters=30,
                                 device_iters=10, device=device, warmup=3)
    rec = {
        "metric": "inference_images_per_sec_chip",
        "value": m["value"],
        "unit": "images/sec",
        "vs_baseline": round(m["value"] / BASELINE_IMAGES_PER_SEC, 4),
        "batch": batch,
        "mfu_pct": m["mfu_pct"],
        "device_batch_ms": m["device_batch_ms"],
        "host_loop_images_per_sec": m["host_loop_images_per_sec"],
        "flops_source": m["flops_source"],
        "card": card(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    run_bench()
