"""Batched inference: one caller sends back-to-back ``Predictor.predict``
calls on one batch of host uint8 images and waits for each call's host
persons (a closed loop).

Traffic parameters: ``batch`` images a call, tiled from ``distinct``
renders of the seed (1 to ``max_persons`` persons each).

Checked after the window, for ``sample_calls`` window calls drawn from
the seed: the feature maps captured from the program's model against the
reference's float32 maps of the same images (``map_err``); the persons
the calls returned against the reference's post-process of the program's
own maps, keypoints found on one side only (``post_mismatch``, exact); and
against the reference's persons from its own maps, the largest gap of a
box both found (``box_err_px``; ``kp_mismatch`` is read beside it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import harness
from perfbench.entries import common
from perfbench.reference.geometry import Geometry
from perfbench.yardstick.flops import forward_flops
from perfbench.yardstick.post_bytes import needed_bytes
from perfbench.yardstick.trace import CALL


class Entry:
    def __init__(self, run: harness.Run):
        self.run = run
        tr = run.traffic
        self.g = Geometry(run.cfg["model"])
        self.batch, self.distinct = tr["batch"], tr["distinct"]
        self.weights = common.model_weights(run)
        data = common.renders(run, self.distinct)
        self.distinct_images = data["image"]
        self.images = np.ascontiguousarray(np.resize(
            data["image"], (self.batch, *data["image"].shape[1:])))
        if run.program == "program":
            self.predictor, self.capture = common.program_predictor(
                run, self.weights)
        else:
            self.predictor = self.capture = common.ReferencePredictor(
                run, self.weights, run.program)
        for _ in range(tr["warmup_calls"]):
            self.predictor.predict(self.images)
        common.sync(run.device)

    def window(self, seconds: float) -> dict:
        run = self.run
        sample = common.Reservoir(run.work["sample_calls"], run.seed)
        calls = 0
        with common.Window(run.trace, run.device) as win:
            while True:
                with torch.profiler.record_function(CALL):
                    people = self.predictor.predict(self.images)
                calls += 1
                sample.offer((people, self.capture.out))
                if win.elapsed() >= seconds:
                    break
            elapsed = win.elapsed()
        self.sample = sample.items
        self.calls = calls
        images = calls * self.batch
        obs = {"trace": win.trace, "calls": calls, "images": images,
               "window_s": elapsed,
               "flops_per_image": forward_flops(self.run.cfg["model"])}
        return {"e2e": {"infer_img_per_s": images / elapsed},
                "attempted": images, "failed": 0, "obs": obs,
                "notes": [f"{calls} calls of {self.batch} images in "
                          f"{elapsed:.3f} s"]}

    def release(self) -> None:
        """Free the program; keep the sampled outputs, maps on the host."""
        self.sample = [(p, fm.cpu()) for p, fm in self.sample]
        self.capture.remove()
        del self.predictor, self.capture
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        run = self.run
        x = torch.from_numpy(self.distinct_images).to(run.device)
        fm = common.reference_maps(run.cfg["model"], self.weights, x)
        want = common.reference_people(self.g, fm)
        self.post_bytes = (needed_bytes(self.g, fm) * self.batch
                           // self.distinct)
        fm = fm.cpu()
        rows = torch.arange(self.batch) % self.distinct
        gap, persons, post = 0.0, common.PersonsGap(), common.PersonsGap()
        for people, got in self.sample:
            gap = max(gap, common.map_gap(got, fm[rows]))
            for i in range(self.batch):
                persons.add(common.keypoint_sets(people, i),
                            common.keypoint_sets(want, i % self.distinct))
            common.add_post_gap(post, self.g, got,
                                {i: (people, i) for i in range(self.batch)},
                                run.device)
        return {"map_err": gap, **persons.numbers(),
                "post_mismatch": post.numbers()["kp_mismatch"]}

    def obs_after_check(self) -> dict:
        return {"post_bytes_per_call": self.post_bytes}
