"""Export a port training checkpoint's eval weights to an f16 snapshot.

Reads the newest ``ckpt_*.pt`` of a checkpoint directory written by the
port's trainer (``train/checkpoint.load_state``) and writes its eval
parameters (the EMA when tracked) and BatchNorm statistics with
``utils/params_io.save_inference_npz``: the ``.npz`` format of the
committed snapshots, which ``Predictor.from_npz``, ``--init-npz`` and the
JAX package's ``load_inference_npz`` read. The flags and the printed line
are those of tools/export_snapshot.py, which does the same for the JAX
package's Orbax checkpoints.

    python tools/torch_export_snapshot.py --config coco_r18_384 \
        --ckpt-dir runs/crowd --ema --out crowd_ema_f16.npz \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ema", action="store_true",
                   help="export the EMA parameters the run tracked (a "
                        "checkpoint without them exports its parameters)")
    p.add_argument("--device", default="cuda",
                   help="torch device the checkpoint is restored on")
    args = p.parse_args(argv)

    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.train.checkpoint import load_state
    from ppn_tpu_torch.utils.params_io import save_inference_npz

    cfg = get_config(args.config)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.999 if args.ema else 0.0))
    state = load_state(cfg, args.ckpt_dir, device=args.device)
    n = save_inference_npz(args.out, state)
    mb = os.path.getsize(args.out) / 1e6
    print(f"step {state.step}: wrote {n} leaves "
          f"({'EMA' if state.ema is not None else 'raw'} params) "
          f"-> {args.out} ({mb:.1f} MB)")


if __name__ == "__main__":
    main()
