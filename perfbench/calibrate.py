"""Read a cell's correctness numbers over many seeds in one process, to set
their limits (the program's lower readings, the control's upper ones):

    python3 perfbench/calibrate.py --workload r18-train-b128 \
        --seeds 1,2,3 --seconds 0 --program fp8

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own load, the program freed, the check; one JSON line of its numbers.
Witnesses for the training cells, each the float32 reference in the
program's place: ``--program nudge`` moves every augmented pixel up one
float32 ulp (the reference read against itself), ``--program image16``
rounds the augmented image to bfloat16, as the configuration's
``augment_dtype`` states, and nothing else. The benchmark's runs never
call it.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import contextlib
    import json

    import torch

    from perfbench import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--program", choices=("program", "fp8", "nudge", "image16"),
                    default="program")
    ap.add_argument("--fault", default=None,
                    help="plant one of perfbench/faults.py's faults")
    args = ap.parse_args(argv)
    found = harness.find_cell(args.workload, harness.manifest())
    Entry = harness.entry_class(found["work"]["entry"])
    print(json.dumps({"card": harness.card_line(),
                      "workload": args.workload, "program": args.program}),
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=args.workload, seed=seed,
                          seconds=args.seconds, trace=False,
                          cfg=found["cfg"], traffic=found["traffic"],
                          work=found["work"], device=torch.device("cuda", 0),
                          program=args.program)
        t0 = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            entry = Entry(run)
            out = entry.window(args.seconds)
        entry.release()
        t1 = time.perf_counter()
        numbers = entry.check()
        t2 = time.perf_counter()
        print(json.dumps({"seed": seed, **numbers,
                          "failed": out["failed"], "setup_window_s": t1 - t0,
                          "check_s": t2 - t1,
                          "notes": getattr(entry, "notes", [])}), flush=True)
        del entry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
