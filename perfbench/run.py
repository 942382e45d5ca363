"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload r18-infer-b128 --seed 7 \
        --seconds 10 --trace 0

Set-up (weights, inputs, the program, every shape the cell uses warmed
up), then ``--seconds`` of measured work, then the correctness check
against the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
from a profiler trace of the window), ``device`` and, with ``--trace 1``,
``breakdown``; its last key, ``checks``, holds each compared number with
its limit, which also close standard error.

``--program fp8`` puts the reference, computed in float8, in the
program's place: the control that the limits are set against. The
benchmark's own runs never pass it.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# every kernel cache a program may keep, at fixed paths inside the checkout
# (listed in .gitignore), so that only a checkout's first run compiles
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")


# the profiler now and then leaves a few of a window's launches without a
# device record; such a window gives no per-layer reading, and is traced
# again, up to this many windows in all
TRACE_TRIES = 3


def unrecorded(tr) -> str:
    at = [t for _, t in tr.unrecorded]
    if not at:
        return "no kernel launch in the window"
    return (f"{len(at)} launches without a device record, {min(at):.4f}-"
            f"{max(at):.4f} s into the window, by "
            f"{sorted({n for n, _ in tr.unrecorded})}")


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", choices=("program", "fp8"),
                    default="program")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    man = harness.manifest()
    found = harness.find_cell(args.workload, man)
    chips = found["manifest"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = harness.card_line()
    print(f"perfbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr)
    run = harness.Run(cell=args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      cfg=found["cfg"], traffic=found["traffic"],
                      work=found["work"], device=torch.device("cuda", 0),
                      program=args.program)
    Entry = harness.entry_class(found["work"]["entry"])
    torch.cuda.reset_peak_memory_stats()
    entry = Entry(run)
    setup_s = time.perf_counter() - T0
    out = entry.window(args.seconds)
    for _ in range(TRACE_TRIES - 1):
        if not run.trace or out["obs"]["trace"].whole:
            break
        print(f"perfbench: {unrecorded(out['obs']['trace'])}; the window is "
              f"traced again", file=sys.stderr)
        again = entry.window(args.seconds)
        again["attempted"] += out["attempted"]
        again["failed"] += out["failed"]
        out = again
    peak = torch.cuda.max_memory_allocated()
    entry.release()
    t_check = time.perf_counter()
    numbers = entry.check()
    t_check = time.perf_counter() - t_check
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4

    checks = harness.judge(numbers, run.work["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace:
        tr = out["obs"]["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["obs"].update(entry.obs_after_check())
        out["obs"]["card"] = device["kind"]
        metrics = harness.read_per_layer(man, args.workload, out["obs"])
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        print(f"perfbench: traced window {tr.window_s:.3f} s, device busy "
              f"{tr.busy_s():.3f} s, launches recorded {tr.recorded}",
              file=sys.stderr)
        if tr.unrecorded:
            print(f"perfbench: {unrecorded(tr)}", file=sys.stderr)
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(man, args.workload,
                                                 "end_to_end")}
    correct = harness.passed(checks) and out["failed"] == 0
    for line in out.get("notes", []) + getattr(entry, "notes", []):
        print(f"perfbench: {line}", file=sys.stderr)
    print(f"perfbench: setup_s {setup_s:.3f}, memory_peak_bytes {peak}, "
          f"check {t_check:.3f} s", file=sys.stderr)
    for k in sorted(set(numbers) - set(checks)):
        print(f"perfbench: reading {k} {numbers[k]!r} (not compared)",
              file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              metrics, device, checks, breakdown, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
