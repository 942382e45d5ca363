"""The stage profilers' full sweep on one GPU, one JSON line per run.

Runs, through each tool's ``main`` at its default iterations:
  * tools/torch_bwd_split.py at B = 32, 64, 128 with ``--batch-norm`` on
    ResNet-18 (``mpii_r18_384``), ResNet-34 (``mpii_r18_384`` with
    ``model.backbone = "resnet34"``, set through
    ``ppn_tpu_torch.testing.replacing_config``) and ResNet-50
    (``mpii_r50_384``);
  * tools/torch_train_split.py on ``mpii_r18_384`` at B = 32 and 128;
  * tools/torch_fwd_split.py on ``mpii_r18_384`` at B = 128.

Each line holds the run's label, the card's ``nvidia-smi`` name and power
limit, and the tool's record. Needs a CUDA device.

    python tools/torch_split_sweep.py --out chiprun_out/split_sweep.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (label, the config's model fields replaced, tool argv)
BWD_RUNS = (("bwd_r18", {}, ["--config", "mpii_r18_384", "--batch-norm"]),
            ("bwd_r34", {"backbone": "resnet34"},
             ["--config", "mpii_r18_384", "--batch-norm"]),
            ("bwd_r50", {}, ["--config", "mpii_r50_384", "--batch-norm"]))
TRAIN_RUNS = (("train_b32", {}, ["--batch", "32"]),
              ("train_b128", {}, ["--batch", "128"]))
FWD_RUNS = (("fwd_b128", {}, ["--batch", "128"]),)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="JSON lines, appended")
    args = p.parse_args(argv)

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.bench.suite import card
    from ppn_tpu_torch.testing import replacing_config
    from tools import torch_bwd_split, torch_fwd_split, torch_train_split

    line = card(resolve_device())           # a card or an error
    for tool, table in ((torch_bwd_split, BWD_RUNS),
                        (torch_train_split, TRAIN_RUNS),
                        (torch_fwd_split, FWD_RUNS)):
        for label, fields, argv_ in table:
            print(f"[split_sweep] {label} | {line}", flush=True)
            with replacing_config(model=fields):
                rec = tool.main(argv_)
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps({"run": label, "model_fields": fields,
                                     "card": line, "record": rec}) + "\n")


if __name__ == "__main__":
    main()
