"""COCO keypoints dataset (a copy of ``ppn_tpu/data/coco.py``): a plain JSON
parser of the official ``person_keypoints_*.json`` files (no pycocotools).

COCO's keypoint order is ``configs.COCO_KEYPOINT_NAMES[1:]`` one to one, so
nothing is remapped: annotations are grouped by image, the image is resized
to the network input (``data/imageio.load_resized``: JPEGs natively, other
files through PIL) and the persons
are padded to the static ``max_persons`` slots. COCO has no head boxes; the
PCKh-style ``headsizes`` are 0.6 · the nose↔ear span (OKS evaluation uses
the instance area instead, ``eval/coco_eval.py``). The arithmetic is the
reference's, in its order, so every field is bitwise the JAX package's on
the same files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.data.imageio import load_resized


class COCOKeypointsDataset:
    """Skips ``iscrowd`` annotations and those with fewer than
    ``min_keypoints`` labelled keypoints. ``native_jpeg``: JPEGs through
    the native decoder (the default, as in the reference), else through
    PIL (``data/imageio.load_resized``)."""

    def __init__(self, cfg: Config, root: str, annotations: str,
                 image_dir: str, indices: Optional[List[int]] = None,
                 min_keypoints: int = 1, native_jpeg: bool = True):
        self.cfg = cfg
        self.image_dir = os.path.join(root, image_dir)
        self.native_jpeg = native_jpeg

        with open(annotations if os.path.isabs(annotations)
                  else os.path.join(root, annotations)) as f:
            data = json.load(f)
        images = {im["id"]: im for im in data["images"]}
        by_image: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd"):
                continue
            if ann.get("num_keypoints", 0) < min_keypoints:
                continue
            by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(by_image)
        self.by_image = by_image
        self.images = images
        if indices is not None:
            self.ids = [self.ids[i] for i in indices]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_id = self.ids[idx]
        info = self.images[img_id]
        anns = self.by_image[img_id][: cfg.data.max_persons]

        Ht, Wt = cfg.model.insize
        img, W0, H0 = load_resized(
            os.path.join(self.image_dir, info["file_name"]), (Ht, Wt),
            native_jpeg=self.native_jpeg)
        sx, sy = Wt / W0, Ht / H0

        P = cfg.data.max_persons
        K = cfg.model.num_keypoints
        keypoints = np.zeros((P, K, 2), np.float32)
        visible = np.zeros((P, K), bool)
        bboxes = np.zeros((P, 4), np.float32)
        valid = np.zeros((P,), bool)
        headsizes = np.zeros((P,), np.float32)
        areas = np.zeros((P,), np.float32)

        for p, ann in enumerate(anns):
            kp = np.asarray(ann["keypoints"], np.float32).reshape(K, 3)
            xy = kp[:, :2] * np.asarray([sx, sy], np.float32)
            vis = kp[:, 2] > 0
            if not vis.any():
                continue
            bx, by, bw, bh = ann["bbox"]
            keypoints[p] = xy
            visible[p] = vis
            bboxes[p] = ((bx + bw / 2) * sx, (by + bh / 2) * sy,
                         bw * sx, bh * sy)
            valid[p] = True
            areas[p] = ann.get("area", bw * bh) * sx * sy
            # nose (0) ↔ ears (3, 4) span as a PCKh-style proxy
            nose, lear, rear = xy[0], xy[3], xy[4]
            span = max(float(np.hypot(*(nose - lear))),
                       float(np.hypot(*(nose - rear))))
            headsizes[p] = 0.6 * span if span > 0 else 0.1 * np.hypot(
                bw * sx, bh * sy)

        return {
            "image": img,  # float32 [0, 1] from load_resized
            "keypoints": keypoints,
            "visible": visible,
            "bboxes": bboxes,
            "valid": valid,
            "headsizes": headsizes,
            "areas": areas,
        }


def make_coco_datasets(cfg: Config, root: str,
                       overfit: Optional[int] = None):
    """(train, val) from the 2017 annotation pair, else the 2014 pair; val
    is None when its file is missing, and the train set itself under
    ``overfit``."""
    pairs = [
        ("annotations/person_keypoints_train2017.json", "train2017",
         "annotations/person_keypoints_val2017.json", "val2017"),
        ("annotations/person_keypoints_train2014.json", "train2014",
         "annotations/person_keypoints_val2014.json", "val2014"),
    ]
    for at, dt, av, dv in pairs:
        if os.path.exists(os.path.join(root, at)):
            train = COCOKeypointsDataset(
                cfg, root, at, dt,
                indices=list(range(overfit)) if overfit else None)
            if overfit:
                return train, train
            val = (COCOKeypointsDataset(cfg, root, av, dv)
                   if os.path.exists(os.path.join(root, av)) else None)
            return train, val
    raise FileNotFoundError(
        f"no COCO person_keypoints annotations under {root}")
