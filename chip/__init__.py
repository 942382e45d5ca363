"""The port's check on one NVIDIA GPU, as a registry of phases that
``chip_smoke.py`` runs in order: ``kernels.py`` holds phases 1-4 and 17,
``inference.py`` 5-12, ``training.py`` 13-16, 18, 19, 24 and 25,
``paths.py`` 20-23 and 26-30; ``context.py`` the ``Context`` and helpers
they share, ``timing.py`` the card timers (which the port's tools use
too).

A phase is ``phase(ctx) -> dict``; its docstring says what it checks, and
it raises on a failure. Its record goes to ``ctx.records`` under its
name. A record's key named after a report line (``REPORT_LINES``) holds
that line's fields, and its ``kernels`` key holds the kernel table's
({kernel: {field: value}}); ``report`` (phase 31) merges and prints them,
and a field that two records set raises, but for the worst ulp and error
(``merge``). So a new check touches its phase and nothing else, and a
phase logs only what its record does not carry. A phase that reads an
earlier one's record says so; to run one alone, run those first:

    import chip
    ctx = chip.Context()
    for number, name, phase in chip.PHASES:
        if number in (1, 30):        # 30 reads no earlier record
            ctx.records[name] = phase(ctx)
"""

from __future__ import annotations

import json

import torch

from chip import inference, kernels, paths, training
from chip.context import Context, log

PHASES = [(n, fn.__name__, fn) for n, fn in enumerate((
    kernels.device, kernels.build, kernels.post_kernel, kernels.warp_kernel,
    inference.snapshot_pckh, inference.predict_b128, inference.flip_tta,
    inference.oks_eval, inference.file_input, inference.latency_b1,
    inference.serve_selftest, inference.video_stream, training.step_vs_cpu,
    training.train_path, training.train_times, training.overfit_fixed,
    kernels.warp_times, training.dp_one_rank, training.dp_two_ranks,
    paths.exported_pipeline, paths.pretrained, paths.profiling_debug,
    paths.native_decode, training.k_step, training.sharded_cache,
    paths.bench_suite, paths.parity_leftovers, paths.model_family,
    paths.accuracy_tools, paths.stage_profilers), 1)]

REPORT_LINES = ("serving_slice", "evaluation_slice", "file_input_slice",
                "ninth_slice", "eleventh_slice", "bench_suite",
                "parity_leftovers", "model_family", "accuracy_tools",
                "stage_profilers")
# the kernel table's fixed fields; the phases' records add the measured ones
KERNELS = (
    {"name": "ppn_post_kernel", "route": "cuda",
     "source": "ppn_tpu_torch/csrc/post.cu",
     "replaces": "ppn_tpu/ops/pallas_post_packed.py:584",
     "also_replaces": "ppn_tpu/ops/pallas_post.py:292", "bound_by": "bytes",
     "library_ms": None, "ms_by": "CUDA graph replay of 50 launches",
     "bound_held_to": "bytes the main-path map needs",
     "decisions_equal": True},
    {"name": "ppn_warp_kernel", "route": "cuda",
     "source": "ppn_tpu_torch/csrc/warp.cu",
     "replaces": "ppn_tpu/ops/pallas_warp.py:166", "bound_by": "bytes",
     "library_ms": None,
     "bound_held_to": "each input pixel read once, each output written once",
     "ms_by": "CUDA graph replay of 50 launches", "batch": 32,
     "dtype": "bfloat16"},
    {"name": "ppn_bn_*", "route": "cuda",
     "source": "ppn_tpu_torch/csrc/batch_norm.cu", "replaces": None,
     "bound_by": "bytes",
     "library": "PyTorch's SyncBatchNorm primitives and a separate ReLU",
     "ms_by": "CUDA graph replay of 20 forward and 20 backward calls",
     "shape": "B=128 64x192x192 bf16, ReLU"})


# the only fields two records may both set: the line keeps the worst
WORST = ("max_ulp", "max_abs_err")


def merge(into: dict, fields: dict, where: str) -> None:
    """Adds ``fields`` to ``into``. A field of ``WORST`` that is already
    there keeps the larger value; any other field set twice raises, so no
    record hides another's."""
    for k, v in fields.items():
        if k not in into:
            into[k] = v
        elif k in WORST:
            into[k] = max(into[k], v)
        else:
            raise KeyError(f"{where}: {k!r} is set twice")


def kernel_table(records: dict) -> list:
    """The ``kernels`` line: each kernel's fixed fields, then the fields
    the phases measured, in phase order."""
    table = {k["name"]: dict(k) for k in KERNELS}
    for record in records.values():
        for name, fields in record.get("kernels", {}).items():
            merge(table[name], fields, name)
    return list(table.values())


def report_line(records: dict, line: str) -> dict:
    """The fields of report line ``line``, gathered from the phases'
    records in phase order."""
    fields = {}
    for record in records.values():
        merge(fields, record.get(line, {}), line)
    return fields


def report(ctx: Context, ok: bool = True) -> None:
    """Phase 31: each line of ``REPORT_LINES``; the card's ``nvidia-smi``
    line; the kernels line; the device line last, only when every phase
    passed (``ok``)."""
    for line in REPORT_LINES:
        log(json.dumps({line: report_line(ctx.records, line)}))
    log(ctx.card)
    log(json.dumps({"kernels": kernel_table(ctx.records)}))
    if ok:
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
