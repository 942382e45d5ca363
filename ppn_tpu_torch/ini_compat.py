"""config.ini compatibility layer (a copy of
``ppn_tpu/configs/ini_compat.py``).

The reference configures experiments through an INI file; this loader maps
the same knob names onto the dataclass config tree so a reference user can
carry their config file over:

    cfg = load_ini("config.ini")                 # starts from mpii_r18_384
    cfg = load_ini("config.ini", base="coco_r18_384")

Recognized keys (any section, case-insensitive; unknown keys are reported,
not silently dropped): insize, outsize, local_grid_size, instance_scale,
parts_scale, lambda_resp/iou/coor/size/limb, detection_thresh, thresh (nms),
min_num_keypoints, keypoint_names, edges, batchsize/batch_size,
learning_rate/lr, momentum, weight_decay, num_steps, seed, train_root/path.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import List, Tuple

from ppn_tpu_torch.configs import Config, get_config


def _parse_size(v: str) -> Tuple[int, int]:
    parts = [int(x) for x in v.replace("x", ",").split(",") if x.strip()]
    if len(parts) == 1:
        return (parts[0], parts[0])
    return (parts[0], parts[1])


def _parse_edges(v: str) -> Tuple[Tuple[int, int], ...]:
    out: List[Tuple[int, int]] = []
    for pair in v.replace(";", "|").split("|"):
        a, b = pair.split(",")
        out.append((int(a), int(b)))
    return tuple(out)


def load_ini(path: str, base: str = "mpii_r18_384",
             strict: bool = False) -> Config:
    """Load a reference-style INI onto the dataclass config tree.

    strict=True raises on unrecognized keys instead of reporting them —
    catches typos in carried-over reference configs.
    """
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f)

    cfg = get_config(base)
    model = dict()
    train = dict()
    data = dict()
    unknown = []

    for section in cp.sections():
        for key, value in cp.items(section):
            k = key.lower()
            if k == "insize":
                model["insize"] = _parse_size(value)
            elif k in ("outsize", "gridsize", "grid_size"):
                model["outsize"] = _parse_size(value)
            elif k == "local_grid_size":
                model["local_grid_size"] = _parse_size(value)
            elif k == "instance_scale":
                model["instance_scale"] = float(value)
            elif k == "parts_scale":
                model["parts_scale"] = float(value)
            elif k in ("lambda_resp", "lambda_iou", "lambda_coor",
                       "lambda_size", "lambda_limb"):
                model[k] = float(value)
            elif k == "detection_thresh":
                model["detection_thresh"] = float(value)
            elif k in ("thresh", "nms_thresh"):
                model["nms_thresh"] = float(value)
            elif k == "min_num_keypoints":
                model["min_num_keypoints"] = int(value)
            elif k == "keypoint_names":
                names = tuple(n.strip() for n in value.split(",") if n.strip())
                if names[0] != "instance":
                    names = ("instance",) + names
                model["keypoint_names"] = names
            elif k == "edges":
                model["edges"] = _parse_edges(value)
            elif k in ("batchsize", "batch_size"):
                train["batch_size"] = int(value)
            elif k in ("learning_rate", "lr"):
                train["learning_rate"] = float(value)
            elif k == "momentum":
                train["momentum"] = float(value)
            elif k == "weight_decay":
                train["weight_decay"] = float(value)
            elif k in ("num_steps", "max_iter"):
                train["num_steps"] = int(value)
            elif k == "seed":
                train["seed"] = int(value)
            elif k in ("train_root", "root", "path", "data_root"):
                data["root"] = value
            elif k in ("rotate", "rotate_deg"):
                data["rotate_deg"] = float(value)
            elif k == "hflip_prob":
                data["hflip_prob"] = float(value)
            else:
                unknown.append(f"{section}.{key}")

    if unknown:
        if strict:
            raise KeyError(f"ini_compat: unknown keys: {unknown}")
        print(f"ini_compat: ignored unknown keys: {unknown}")

    if "insize" in model and "outsize" not in model:
        # the reference's grid is the stride-32 backbone output; an INI
        # that sets only insize implies the matching grid
        sy, sx = cfg.model.stride
        h, w = model["insize"]
        if h % sy or w % sx:
            raise ValueError(
                f"ini_compat: insize {model['insize']} is not a multiple "
                f"of the backbone stride {cfg.model.stride}; set outsize "
                "explicitly")
        model["outsize"] = (int(h // sy), int(w // sx))

    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, **train),
        data=dataclasses.replace(cfg.data, **data),
    )
