#!/usr/bin/env python3
"""The PyTorch port's (``ppn_tpu_torch``) check on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the phases of ``chip.PHASES`` in order, 1 to 30, each raising on a
failure, then the report (phase 31): one JSON line per slice, the card's
``nvidia-smi`` line, the kernel table and ``{"ok": true, ...}`` last (a
failed phase prints the report of those before it, without that line).
Exits 2 without a CUDA device. What each phase checks is its function's
docstring in ``chip/``; ``chip/__init__.py`` shows how to run one alone.

Launch counts are set to 0 just before each path a phase counts and read
just after it; comparison and timing launches fall outside those windows.
"""

from __future__ import annotations

import sys
import time

import torch

from chip import PHASES, Context, log, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ctx = Context()
    try:
        for number, name, phase in PHASES:
            t0 = time.perf_counter()
            log(f"[phase {number}] {name}")
            ctx.records[name] = phase(ctx)
            log(f"[phase {number}] {name} done in "
                f"{time.perf_counter() - t0:.1f} s")
    except BaseException:
        report(ctx, ok=False)       # what the phases before it measured
        raise
    report(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
