"""Pieces the entries share: the traced window, a seeded sample of calls,
the capture of the model's output, the inference set-up and the
comparison of feature maps and persons with the reference."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import model as refmodel
from perfbench.reference import post as refpost
from perfbench.reference.geometry import Geometry
from perfbench.yardstick import synthetic, weights
from perfbench.yardstick.trace import WINDOW, Profiler, Trace, open_window


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window; under ``trace`` a ``Profiler`` records it,
    opened by the uncounted markers, and ``trace`` then holds its
    readings."""

    def __init__(self, trace: bool, device):
        self.enabled, self.device = trace, device
        self.trace: Optional[Trace] = None

    def __enter__(self) -> "Window":
        if self.enabled:
            self._prof = Profiler(self.device)
            self._prof.__enter__()
            open_window(self.device)
            self._span = torch.profiler.record_function(WINDOW)
            self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        sync(self.device)
        if self.enabled:
            self._span.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = Trace(self._prof.events)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 17])

    def offer(self, item) -> None:
        if self.n < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


class Capture:
    """Keeps the last output of a module (a reference, no copy)."""

    def __init__(self, module: torch.nn.Module):
        self.out: Optional[torch.Tensor] = None
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, inputs, out) -> None:
        self.out = out

    def remove(self) -> None:
        self.handle.remove()
        self.out = None


def model_weights(run: harness.Run) -> Dict[str, torch.Tensor]:
    """The cell's weights on the device: its snapshot (held to its sha256)
    or drawn from the seed."""
    m, w = run.cfg["model"], run.work["weights"]
    if w["kind"] == "snapshot":
        path = str(harness.ROOT / w["path"])
        got = weights.sha256(path)
        if got != w["sha256"]:
            raise ValueError(f"{w['path']} has sha256 {got}, the cell "
                             f"names {w['sha256']}")
        return weights.load_snapshot(m, path, run.device)
    return weights.seeded(m, run.seed, run.device)


def renders(run: harness.Run, count: int) -> Dict[str, np.ndarray]:
    m = run.cfg["model"]
    return synthetic.render_set(m, run.cfg["data"]["max_persons"], run.seed,
                                count, workers=run.workers)


def program_predictor(run: harness.Run, w: Dict[str, torch.Tensor]):
    """The program's ``Predictor`` over the weights, and a capture of its
    model's feature map."""
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.nn.model import DTYPES, PoseProposalNet

    pcfg = harness.program_config(run.cfg)
    with torch.device(run.device):
        model = PoseProposalNet(pcfg.model, dtype=DTYPES[pcfg.train.dtype])
    model.load_state_dict(w)
    pred = Predictor(pcfg, model, device=run.device)
    return pred, Capture(pred.model)


class ReferencePredictor:
    """The reference put in the program's place (the control): the same
    call, host images in, host persons out."""

    def __init__(self, run: harness.Run, w: Dict[str, torch.Tensor],
                 precision: str):
        self.m, self.g = run.cfg["model"], Geometry(run.cfg["model"])
        self.w, self.device, self.precision = w, run.device, precision
        self.out: Optional[torch.Tensor] = None

    @torch.no_grad()
    def predict(self, images: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        fm = reference_maps(self.m, self.w, x, self.precision)
        self.out = fm
        ppl = refpost.postprocess(self.g, fm)
        return type(ppl)(*(t.cpu().numpy() for t in ppl))

    def remove(self) -> None:
        self.out = None


def reference_maps(m: dict, w: Dict[str, torch.Tensor], images: torch.Tensor,
                   precision: str = "float32", rows: int = 16) -> torch.Tensor:
    """The reference's feature maps in eval mode, ``rows`` images at a time,
    with TF32 off."""
    with no_tf32(), torch.no_grad():
        return torch.cat([refmodel.forward(m, w, images[i:i + rows],
                                           precision=precision)
                          for i in range(0, len(images), rows)])


class no_tf32:
    """float32 convolutions and matmuls without TF32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def keypoint_sets(ppl, i: int) -> Dict[tuple, np.ndarray]:
    """Image ``i``'s found keypoints of valid persons: (class, iy, ix) → box."""
    out = {}
    valid = np.asarray(ppl.valid[i])
    kv = np.asarray(ppl.kp_valid[i])
    cell = np.asarray(ppl.kp_cell[i])
    box = np.asarray(ppl.kp_box[i])
    for p in np.flatnonzero(valid):
        for c in np.flatnonzero(kv[p]):
            out[(int(c), int(cell[p, c, 0]), int(cell[p, c, 1]))] = box[p, c]
    return out


class PersonsGap:
    """Accumulates the disagreement of served persons with the reference's:
    keypoints found on one side only, over those found on either, and the
    largest gap of a box found on both (pixels)."""

    def __init__(self):
        self.diff = self.union = 0
        self.box = 0.0

    def add(self, got: Dict[tuple, np.ndarray],
            want: Dict[tuple, np.ndarray]) -> None:
        """One image's keypoints: (class, iy, ix) → box, of both sides."""
        self.diff += len(got.keys() ^ want.keys())
        self.union += len(got.keys() | want.keys())
        for k in got.keys() & want.keys():
            self.box = max(self.box, float(np.max(np.abs(got[k] - want[k]))))

    def numbers(self) -> Dict[str, float]:
        return {"kp_mismatch": self.diff / max(self.union, 1),
                "box_err_px": self.box}


def map_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over images, of ‖got − want‖ / ‖want‖."""
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    return float((d / want.float().flatten(1).norm(dim=1)).max())


def add_post_gap(gap: "PersonsGap", g, fm: torch.Tensor, rows: dict,
                 device) -> None:
    """Adds the program's persons (``rows``: row of ``fm`` → persons of
    that image) against the reference's post-process of the program's own
    map of them: the post-process stage followed from the program's state,
    the map being checked by itself."""
    want = reference_people(g, fm.to(device))
    for r, (ppl, i) in rows.items():
        gap.add(keypoint_sets(ppl, i), keypoint_sets(want, r))


def reference_people(g, fm: torch.Tensor):
    ppl = refpost.postprocess(g, fm)
    return type(ppl)(*(t.cpu().numpy() for t in ppl))


def summary(values: List[float]) -> str:
    v = np.asarray(values)
    if not len(v):
        return "none"
    return (f"n {len(v)}, median {np.median(v):.6g}, p95 "
            f"{np.percentile(v, 95):.6g}, max {v.max():.6g}")
