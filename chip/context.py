"""What the phases share: the paths and limits several of them read, the
helpers they call, and ``Context``, which builds each shared piece once,
when a phase first asks for it. Nothing here touches the device or
imports the port's package until it is called."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from chip.timing import smi_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
COCO_SNAPSHOT = os.path.join(ROOT, "artifacts", "coco_hero_r3_ema_f16.npz")
CROWD_SNAPSHOT = os.path.join(ROOT, "artifacts", "crowd_hero_r5_ema_f16.npz")
ULP_LIMIT = 4   # σ and box floats: same formula on both sides, so 0 is
                # expected; 4 leaves room for a different expf rounding
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
TRAIN_IMAGES = 256       # the synthetic images cached on the card
OVERFIT_STEPS = 60
VIDEO_FRAMES = 64        # synthetic 720p frames of a video run


def log(msg: str) -> None:
    print(msg, flush=True)


def quiet_call(fn, *args):
    """fn(*args) with its standard output captured: (result, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def compare(got, want) -> tuple[bool, int, float]:
    """(decisions bitwise equal, max ulp, max abs error) of two People."""
    from ppn_tpu_torch.testing import max_ulp

    equal = all(torch.equal(getattr(got, f), getattr(want, f))
                for f in DECISIONS)
    ulp, err = 0, 0.0
    for f in FLOATS:
        g, w = getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy()
        ulp = max(ulp, max_ulp(g, w))       # a lone NaN counts as 2**32
        d = np.abs(g - w)
        err = max(err, float(np.where(np.isnan(d), 0.0, d).max(initial=0.0)))
    return equal, ulp, err


def free_port() -> int:
    """A TCP port on the loopback address that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def constant_lr(cfg, **train):
    """``cfg`` with a constant learning rate from the first step (the
    config's rate, no warmup: the default warmup starts at lr 0, which
    would leave the first step's parameters where they were)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_schedule="constant", warmup_steps=0, **train))


def max_rel_state(got: dict, want: dict) -> tuple[float, str]:
    """The worst |got − want| / max|want| over the tensors of a state, and
    its tensor."""
    return max((float((got[k].float() - want[k].float()).abs().max())
                / max(float(want[k].float().abs().max()), 1e-30), k)
               for k in want)


def same_state(a, b) -> bool:
    """Whether two train states are bitwise equal: parameters, BatchNorm
    statistics, momentum traces, EMA, step and generator."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step
            and all(torch.equal(v, sb[k]) for k, v in sa.items())
            and all(torch.equal(v, b.trace[k]) for k, v in a.trace.items())
            and (a.ema is None) == (b.ema is None)
            and all(torch.equal(v, b.ema[k]) for k, v in (a.ema or {}).items())
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


@contextlib.contextmanager
def scratch_dir(prefix: str):
    """A fresh directory under the checkout's ``build/``, removed on exit."""
    d = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(ROOT, "build"))
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def frame_vs_plain(cfg, model, frame: np.ndarray) -> tuple[bool, int, int]:
    """One video frame through ``apps/video.make_video_pipeline`` (the post
    kernel) against the plain pipeline (resize, ``model``,
    ``postprocess_batch_plain``): (decisions equal, max ulp, persons)."""
    from ppn_tpu_torch.apps import video
    from ppn_tpu_torch.ops.image import resize_bilinear
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    got = video.make_video_pipeline(cfg, model)(frame)
    with torch.no_grad():
        img = resize_bilinear(torch.from_numpy(frame).to(
            next(model.parameters()).device).float() / 255.0,
            cfg.model.insize)
        want = postprocess_batch_plain(cfg.model, model(img[None]))
    want = type(want)(*(t[0] for t in want))
    equal, ulp, _ = compare(got, want)
    return equal, ulp, int(want.valid.sum())


def video_cli(argv: list) -> dict:
    """``apps/video.main --json`` on ``argv``: its summary, with the run's
    post launches under ``launches``; raises unless there is one a frame
    and one for the warm-up frame."""
    from ppn_tpu_torch.apps import video
    from ppn_tpu_torch.ops import cuda_post

    cuda_post.LAUNCHES = 0
    summary, _ = quiet_call(video.main, argv + ["--json"])
    summary["launches"] = cuda_post.LAUNCHES
    if summary["launches"] != summary["frames"] + 1:
        raise AssertionError(f"video {argv}: {summary['launches']} post "
                             f"launches for {summary['frames']} frames and "
                             "the warm-up")
    return summary


def metrics(logdir: str) -> list:
    """The records a trainer logged to ``<logdir>/train_metrics.jsonl``."""
    with open(os.path.join(logdir, "train_metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def train_cli(argv: list, ck: str) -> dict:
    """``apps/train.main`` on ``argv`` at B=32 into a fresh ``ck``, every
    step logged: each step's loss_total, the warp and post launches, the
    median step (ms, host clock between the per-step logs), the wall time,
    the ``eval:`` lines' dicts and what it printed."""
    import ast
    import re

    from ppn_tpu_torch.apps import train
    from ppn_tpu_torch.ops import cuda_post, cuda_warp

    cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
    t0 = time.perf_counter()
    _, printed = quiet_call(train.main, argv + [
        "--batch-size", "32", "--no-resume", "--ckpt-dir", ck, "--log-dir",
        ck, "--set", "train.log_every=1"])
    wall = time.perf_counter() - t0
    logged = metrics(ck)
    # the printed dict's values may be numpy scalars: np.float64(0.97)
    evals = [ast.literal_eval(re.sub(r"np\.\w+\(", "(", line[6:]))
             for line in printed.splitlines() if line.startswith("eval: ")]
    return {"losses": [r["loss_total"] for r in logged if "loss_total" in r],
            "warp_launches": cuda_warp.LAUNCHES,
            "post_launches": cuda_post.LAUNCHES,
            "step_ms_median": statistics.median(
                1e3 * 32 / r["images_per_sec"] for r in logged
                if "images_per_sec" in r),
            "cli_s": wall, "evals": evals, "printed": printed}


def overfit(cfg, fixed: dict, dev, label: str):
    """OVERFIT_STEPS ``train_step`` calls of ``cfg`` at its rate held
    constant from the first step, from a fresh init on the 8 ``fixed``
    images, augmentation off; raises unless the mean loss_total of the
    last 10 is under half the first's. Returns the state, the first loss
    and that mean."""
    from ppn_tpu_torch.train import steps as st

    ocfg = constant_lr(cfg)
    state = st.create_train_state(ocfg, device=dev)
    curve = [float(st.train_step(ocfg, state, fixed)["loss_total"])
             for _ in range(OVERFIT_STEPS)]
    tail = statistics.fmean(curve[-10:])
    log(f"{label} loss_total first {curve[0]:.4f}, mean of the last 10 "
        f"{tail:.4f} after {OVERFIT_STEPS} steps (every 10th: "
        f"{[round(v, 3) for v in curve[::10]]})")
    if not all(math.isfinite(v) for v in curve) or not tail < 0.5 * curve[0]:
        raise AssertionError(f"{label} did not halve the loss")
    return state, curve[0], tail


class Context:
    """What the phases share. Each piece is built when a phase first asks
    for it, and once; ``records`` holds each phase's record under its
    name, for the phases that read an earlier one and for the report."""

    def __init__(self):
        self.dev = torch.device("cuda")
        self.records = {}

    def drop(self, *names: str) -> None:
        """Free pieces no later phase needs (built again if one asks)."""
        for name in names:
            self.__dict__.pop(name, None)

    @functools.cached_property
    def card(self) -> str:
        """The card's ``nvidia-smi`` name and power limit line."""
        return smi_line()

    @functools.cached_property
    def mpii(self):
        from ppn_tpu_torch.configs import get_config

        return get_config("mpii_r18_384")

    @functools.cached_property
    def cfg(self):
        """mpii_r18_384 at the protocol's thresholds, det 0.02 and nms
        0.45."""
        return dataclasses.replace(self.mpii, model=dataclasses.replace(
            self.mpii.model, detection_thresh=0.02, nms_thresh=0.45))

    @functools.cached_property
    def tiny(self):
        from ppn_tpu_torch.configs import get_config

        return get_config("tiny_test")

    @functools.cached_property
    def val(self):
        """The 16-image held-out synthetic protocol (two persons)."""
        from ppn_tpu_torch.data.synthetic import heldout_dataset

        return heldout_dataset(self.cfg, num_persons=2)

    @functools.cached_property
    def train_ds(self):
        from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

        return SyntheticPoseDataset(self.mpii, size=TRAIN_IMAGES, seed=0,
                                    cache=True)

    @functools.cached_property
    def cache(self):
        """``train_ds`` in a ``DeviceCache`` on the card."""
        from ppn_tpu_torch.data.device_cache import DeviceCache

        t0 = time.perf_counter()
        cache = DeviceCache(self.train_ds, device=self.dev)
        log(f"[data] {TRAIN_IMAGES} synthetic images rendered and cached on "
            f"the card ({cache.nbytes() / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f} s")
        return cache

    @functools.cached_property
    def predictor(self):
        """``Predictor`` of the committed MPII snapshot at ``cfg``."""
        from ppn_tpu_torch.inference import Predictor

        return Predictor.from_npz(self.cfg, SNAPSHOT)

    @functools.cached_property
    def tta_predictor(self):
        from ppn_tpu_torch.inference import Predictor

        return Predictor.from_npz(self.cfg, SNAPSHOT, flip_tta=True)

    @functools.cached_property
    def images(self) -> np.ndarray:
        """uint8 (128, 384, 384, 3) drawn from seed 0."""
        return np.random.default_rng(0).integers(
            0, 256, (128, *self.cfg.model.insize, 3), dtype=np.uint8)

    @functools.cached_property
    def fixed(self) -> dict:
        """The first 8 cached images as one batch, on the card."""
        return self.cache.batch(np.arange(8))
