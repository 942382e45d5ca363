"""Single-image inference CLI (port of ``ppn_tpu/apps/predict.py``): the
same flags, plus ``--device``.

Loads weights (an inference snapshot ``.npz``, the newest of the port's own
checkpoints in a directory, or a fresh init), runs forward (with
``--flip-tta``, the mirrored forward merged in logit space) and the fused
post-process, prints the poses as JSON and optionally writes a picture.

    python -m ppn_tpu_torch.apps.predict --config mpii_r18_384 \
        --ckpt-dir artifacts/mpii_hero_r5_ema_f16.npz --synthetic 0 --flip-tta
    python -m ppn_tpu_torch.apps.predict --config tiny_test --synthetic 0 \
        --device cpu

``--ini`` applies a reference-style config.ini over ``--config``, and
``--set`` applies over that. ``--image`` and ``--out`` need PIL, imported
only for them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_image(cfg, args) -> np.ndarray:
    """(H, W, 3) float32 [0,1] at the network input size."""
    if args.synthetic is not None:
        from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

        ds = SyntheticPoseDataset(cfg, size=max(args.synthetic + 1, 1),
                                  seed=11)
        return ds[args.synthetic]["image"]
    from PIL import Image

    img = Image.open(args.image).convert("RGB")
    img = img.resize((cfg.model.insize[1], cfg.model.insize[0]),
                     Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def people_to_json(cfg, people) -> list:
    """One image's ``People`` (host arrays) as a list of persons."""
    out = []
    kp_box = np.asarray(people.kp_box)
    kp_valid = np.asarray(people.kp_valid)
    kp_score = np.asarray(people.kp_score)
    valid = np.asarray(people.valid)
    for p in range(valid.shape[0]):
        if not valid[p]:
            continue
        person = {"score": float(kp_score[p, 0]),
                  "instance_box": [round(float(v), 2) for v in kp_box[p, 0]],
                  "keypoints": {}}
        for c in range(1, cfg.model.num_classes):
            if kp_valid[p, c]:
                person["keypoints"][cfg.model.keypoint_names[c]] = {
                    "xy": [round(float(kp_box[p, c, 0]), 2),
                           round(float(kp_box[p, c, 1]), 2)],
                    "score": round(float(kp_score[p, c]), 4)}
        out.append(person)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="PPN single-image inference")
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ini", default=None, metavar="PATH",
                   help="reference-style config.ini applied over --config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--image", default=None)
    p.add_argument("--synthetic", type=int, default=None,
                   help="use synthetic sample N instead of --image")
    p.add_argument("--out", default=None, help="write visualization PNG")
    p.add_argument("--flip-tta", action="store_true",
                   help="horizontal-flip TTA: merge the mirrored "
                        "prediction in logit space (ops/tta.py)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="PATH=VALUE",
                   help="dotted-path config override, e.g. "
                        "model.detection_thresh=0.05 (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    if (args.image is None) == (args.synthetic is None):
        p.error("exactly one of --image / --synthetic is required")

    from ppn_tpu_torch.configs import resolve_config
    from ppn_tpu_torch.inference import Predictor

    cfg = resolve_config(args.config, args.ini)
    if args.overrides:
        from ppn_tpu_torch.overrides import apply_overrides

        cfg = apply_overrides(cfg, args.overrides)
    predictor = Predictor.from_checkpoint(cfg, args.ckpt_dir,
                                          flip_tta=args.flip_tta,
                                          device=args.device)
    if args.ckpt_dir:
        print(f"loaded {args.ckpt_dir}", file=sys.stderr)
    image = load_image(cfg, args)
    people = predictor.predict_single(image)

    print(json.dumps(people_to_json(cfg, people), indent=1))
    if args.out:
        from ppn_tpu_torch.utils.draw import draw_people

        draw_people(cfg.model, image, people).save(args.out)
        print(f"wrote {args.out}")
    return people


if __name__ == "__main__":
    main()
