"""MPII Human Pose dataset (a copy of ``ppn_tpu/data/mpii.py``).

Parses the widely used JSON conversion of the MPII annotations (one record
per annotated person):

    {"image": "015601864.jpg", "joints": [[x, y] × 16],
     "joints_vis": [0/1 × 16], "center": [x, y], "scale": s,
     "headbox": [x0, y0, x1, y1]?}            # headbox optional

Records are grouped by image into multi-person samples, resized on the host
to the network input size (``data/imageio.load_resized``: JPEGs natively,
other files through PIL; augmentation
runs on the device, ``ops/augment.py``), and emitted in the GT contract of
``ops/encode.py`` plus per-person ``headsizes`` for PCKh. The arithmetic is
the reference's, in its order, so every field is bitwise the JAX package's
on the same files.

MPII joint order → framework class order is remapped here; the framework
order is ``configs.MPII_KEYPOINT_NAMES`` (instance first).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.data.imageio import load_resized

# Standard MPII joint indices.
_MPII_ORDER = (
    "r_ankle", "r_knee", "r_hip", "l_hip", "l_knee", "l_ankle",
    "pelvis", "thorax", "upper_neck", "head_top",
    "r_wrist", "r_elbow", "r_shoulder", "l_shoulder", "l_elbow", "l_wrist",
)


def _remap_indices(cfg: Config) -> np.ndarray:
    """perm[k] = MPII joint index for framework keypoint class k+1."""
    names = cfg.model.keypoint_names[1:]
    return np.asarray([_MPII_ORDER.index(n) for n in names], np.int64)


def load_annotations(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # some conversions wrap in {"root": [...]}
        for key in ("root", "annotations", "data"):
            if key in data:
                data = data[key]
                break
    if not isinstance(data, list):
        raise ValueError(f"unrecognized MPII annotation layout in {path}")
    return data


class MPIIDataset:
    """Map-style multi-person MPII dataset in the framework GT contract.

    ``native_jpeg``: JPEGs through the native decoder (the default, as
    in the reference), else through PIL (``data/imageio.load_resized``)."""

    def __init__(self, cfg: Config, root: str, annotations: str,
                 image_dir: str = "images",
                 indices: Optional[List[int]] = None,
                 native_jpeg: bool = True):
        self.cfg = cfg
        self.root = root
        self.image_dir = os.path.join(root, image_dir)
        self.perm = _remap_indices(cfg)
        self.native_jpeg = native_jpeg

        records = load_annotations(
            annotations if os.path.isabs(annotations)
            else os.path.join(root, annotations))
        by_image: Dict[str, List[dict]] = {}
        for r in records:
            name = r.get("image") or r.get("img_paths") or r.get("im_name")
            if name is None:
                continue
            by_image.setdefault(os.path.basename(name), []).append(r)
        self.images = sorted(by_image)
        self.people = by_image
        if indices is not None:
            self.images = [self.images[i] for i in indices]

    def __len__(self) -> int:
        return len(self.images)

    def _person_gt(self, rec: dict) -> Tuple[np.ndarray, np.ndarray, float]:
        joints = np.asarray(rec["joints"], np.float32).reshape(16, 2)
        vis = np.asarray(
            rec.get("joints_vis", np.ones(16)), np.float32).reshape(-1)[:16]
        vis = (vis > 0) & (joints[:, 0] > 0) & (joints[:, 1] > 0)
        if "headbox" in rec:
            hb = np.asarray(rec["headbox"], np.float32)
            headsize = 0.6 * float(np.hypot(hb[2] - hb[0], hb[3] - hb[1]))
        elif vis[8] and vis[9]:
            # the head segment's length (head_top ↔ upper_neck)
            headsize = float(np.hypot(*(joints[9] - joints[8])))
        else:
            # unannotated head joints carry sentinel coordinates: the
            # caller derives a keypoint-extent headsize instead
            headsize = 0.0
        return joints, vis, headsize

    @staticmethod
    def _instance_box(rec: dict, kp: np.ndarray, kvis: np.ndarray,
                      sx: float, sy: float) -> Tuple[float, float, float,
                                                     float]:
        """Person instance box (cx, cy, w, h) in resized-image pixels.

        Uses the annotation's ``center``/``scale`` when both are usable —
        the MPII convention: the person occupies a square of side
        200·scale px around ``center``. Otherwise (MPII marks a missing
        center with -1) the visible-keypoint extent × 1.15."""
        center = rec.get("center")
        scale = float(rec.get("scale", 0.0) or 0.0)
        if (center is not None and scale > 0
                and float(center[0]) > 0 and float(center[1]) > 0):
            side = 200.0 * scale
            return (float(center[0]) * sx, float(center[1]) * sy,
                    side * sx, side * sy)
        vpts = kp[kvis]
        x0, y0 = vpts.min(axis=0)
        x1, y1 = vpts.max(axis=0)
        bw = max(x1 - x0, 8.0) * 1.15
        bh = max(y1 - y0, 8.0) * 1.15
        return ((x0 + x1) / 2, (y0 + y1) / 2, bw, bh)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        name = self.images[idx]
        recs = self.people[name][: cfg.data.max_persons]
        Ht, Wt = cfg.model.insize
        img, W0, H0 = load_resized(os.path.join(self.image_dir, name),
                                   (Ht, Wt), native_jpeg=self.native_jpeg)
        sx, sy = Wt / W0, Ht / H0

        P = cfg.data.max_persons
        K = cfg.model.num_keypoints
        keypoints = np.zeros((P, K, 2), np.float32)
        visible = np.zeros((P, K), bool)
        bboxes = np.zeros((P, 4), np.float32)
        valid = np.zeros((P,), bool)
        headsizes = np.zeros((P,), np.float32)

        for p, rec in enumerate(recs):
            joints, vis, headsize = self._person_gt(rec)
            joints = joints * np.asarray([sx, sy], np.float32)
            kp = joints[self.perm]
            kvis = vis[self.perm]
            if not kvis.any():
                continue
            keypoints[p] = kp
            visible[p] = kvis
            bboxes[p] = self._instance_box(rec, kp, kvis, sx, sy)
            valid[p] = True
            if headsize > 0:
                headsizes[p] = headsize * (sx + sy) / 2
            else:
                # The PCKh threshold from the tight keypoint extent, not
                # the instance box: a center/scale box is the full
                # 200·scale square, whose diagonal is ~45% larger, and
                # would loosen PCKh for exactly the persons lacking head
                # annotations.
                vpts = kp[kvis]
                ext_w = max(float(vpts[:, 0].max() - vpts[:, 0].min()), 8.0)
                ext_h = max(float(vpts[:, 1].max() - vpts[:, 1].min()), 8.0)
                headsizes[p] = 0.2 * float(np.hypot(ext_w * 1.15,
                                                    ext_h * 1.15))

        return {
            "image": img,  # float32 [0, 1] from load_resized
            "keypoints": keypoints,
            "visible": visible,
            "bboxes": bboxes,
            "valid": valid,
            "headsizes": headsizes,
        }


def make_mpii_datasets(cfg: Config, root: str,
                       overfit: Optional[int] = None):
    """(train, val) datasets from the standard annotation file names; val
    is None when no validation file exists, and the train set itself under
    ``overfit``."""
    cands_train = ["annotations/train.json", "annot/train.json",
                   "mpii_train.json", "train.json"]
    cands_val = ["annotations/valid.json", "annot/valid.json",
                 "mpii_val.json", "valid.json", "val.json"]

    def first_existing(cands):
        for c in cands:
            if os.path.exists(os.path.join(root, c)):
                return c
        return None

    at = first_existing(cands_train)
    av = first_existing(cands_val)
    if at is None:
        raise FileNotFoundError(
            f"no MPII annotation json under {root} (tried {cands_train}); "
            "expected the standard JSON conversion of MPII annotations")
    if overfit:
        train = MPIIDataset(cfg, root, at, indices=list(range(overfit)))
        return train, train
    train = MPIIDataset(cfg, root, at)
    val = MPIIDataset(cfg, root, av) if av else None
    return train, val
