"""Cells at the program's ``tiny_test`` size on the CPU, for the tests."""

from __future__ import annotations

import dataclasses
import json

import torch

from perfbench import harness

ARCH = {"resnet18": {"block": "basic", "stage_sizes": [2, 2, 2, 2]},
        "resnet50": {"block": "bottleneck", "stage_sizes": [3, 4, 6, 3]}}


def config_file(program_config: str = "tiny_test",
                backbone: str = "resnet18") -> dict:
    """A configuration file of the program's named config, in the layout of
    ``perfbench/configs/*.json``."""
    from ppn_tpu_torch.configs import get_config

    c = get_config(program_config)
    if backbone != c.model.backbone:
        c = dataclasses.replace(
            c, model=dataclasses.replace(c.model, backbone=backbone))
    d = json.loads(json.dumps(dataclasses.asdict(c)))
    model = dict(d["model"], **ARCH[backbone])
    model.update({"widths": [64, 128, 256, 512], "stem_kernel": 7,
                  "head_width": 512, "head_leaky_slope": 0.1,
                  "head_bias_init": -1.0, "bn_momentum": 0.9, "bn_eps": 1e-5,
                  "normalize_mean": [0.485, 0.456, 0.406],
                  "normalize_std": [0.229, 0.224, 0.225]})
    return {"name": program_config, "program_config": program_config,
            "model": model, "train": d["train"], "data": d["data"],
            "reduced": []}


def program_config(cfg: dict):
    """``harness.program_config`` for a tiny file of another backbone: the
    program's tiny_test with the file's backbone."""
    from ppn_tpu_torch.configs import get_config

    pc = get_config(cfg["program_config"])
    return dataclasses.replace(pc, model=dataclasses.replace(
        pc.model, backbone=cfg["model"]["backbone"]))


def run(entry_file: dict, traffic: dict, seed: int = 3, trace=False,
        program="program", cfg=None) -> harness.Run:
    return harness.Run(cell="tiny", seed=seed, seconds=0.0, trace=trace,
                       cfg=cfg or config_file(), traffic=traffic,
                       work=entry_file, device=torch.device("cpu"),
                       program=program, workers=1)
