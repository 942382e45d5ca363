"""Training on the HRNet-W32 trunk: ``entries/train.py``'s cell (the
program's K-step call over a device-resident uint8 ``DeviceCache``,
augmentation on, the window, the watched calls and the check against the
float32 reference), with the model's own pieces in place of ResNet's:
the forward, the parameter shapes and BatchNorm statistics of
``reference/hrnet.py``, the seeded weights of ``yardstick/weights_hrnet``
and the FLOPs of ``yardstick/flops_hrnet``.

Everything else is ``entries/train.py``'s and ``reference/train.py``'s,
by import: the augmentation, encoding, loss and SGD step of the
reference, ``IndexBlocks``, ``_WatchedFeed``, the program's set-up and
call, and the gap arithmetic. Three methods of ``train.Entry`` name the
ResNet reference inside their bodies (the weights in ``__init__``, the
reference's ``Trainer`` in ``_reference_setup`` and ``_follow``, the FLOPs
in ``window``): they are copied here with the HRNet pieces in its place.

The reference's step recomputes each stage's pieces in its backward
(``reference/hrnet.forward(checkpoint=True)``), so that a float32 step
fits at B=128 with the same arithmetic.

With ``--trace 1`` the window also reads the program's spans
(``yardstick/spans.py``): the device time launched inside the exchange
units' ``ppn.hrnet.fuse`` spans, and the kernel launches inside the calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import harness
from perfbench.entries import common
from perfbench.entries import train as base
from perfbench.reference import hrnet as refhrnet
from perfbench.reference import train as reftrain
from perfbench.yardstick import flops_hrnet, weights_hrnet
from perfbench.yardstick.spans import FUSE, Spans
from perfbench.yardstick.trace import CALL


class Trainer(reftrain.Trainer):
    """The reference's training state and step on the HRNet forward."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 seed: int, device, precision: str = "float32"):
        from perfbench.reference.geometry import Geometry

        self.cfg, self.m, self.t = cfg, cfg["model"], cfg["train"]
        self.g = Geometry(self.m)
        self.precision = precision
        stats = set(refhrnet.buffer_names(self.m))
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       for k, v in weights.items() if k not in stats}
        self.stats = {k: weights[k].detach().to(device, torch.float32).clone()
                      for k in stats}
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def step(self, batch: Dict[str, torch.Tensor]):
        aug = reftrain.augment(self.g, self.cfg["data"], self.generator,
                               batch, self.precision)
        targets = reftrain.encode(self.g, aug["keypoints"], aug["visible"],
                                  aug["bboxes"], aug["valid"])
        leaves = {k: v.requires_grad_(True) for k, v in self.params.items()}
        fm = refhrnet.forward(self.m, {**leaves, **self.stats}, aug["image"],
                              train=True, stats=self.stats,
                              precision=self.precision, checkpoint=True)
        terms = reftrain.loss(self.g, fm, targets)
        names = list(leaves)
        grads = torch.autograd.grad(terms["loss_total"],
                                    [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        self._sgd(grads)
        return {k: v.detach() for k, v in terms.items()}, grads


class _Window(common.Window):
    """The measured window; traced, it also keeps the program's spans."""

    spans = None

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if self.trace is not None:
            self.spans = Spans(self._prof.events, (CALL, FUSE))


def _counters():
    """The program's BatchNorm kernel launches and exchange units so far."""
    from ppn_tpu_torch.nn import hrnet
    from ppn_tpu_torch.ops import cuda_bn

    return cuda_bn.LAUNCHES, hrnet.FUSES


class Entry(base.Entry):
    def __init__(self, run: harness.Run):
        self.run = run
        tr = run.traffic
        self.B, self.K = tr["batch"], tr["steps_per_call"]
        if run.work["weights"]["kind"] != "seeded":
            raise ValueError("the HRNet cell draws its weights from the "
                             "seed; no snapshot exists")
        self.weights = weights_hrnet.seeded(run.cfg["model"], run.seed,
                                            run.device)
        self.renders = common.renders(run, tr["renders"])
        self.blocks = base.IndexBlocks(run.seed, tr["rows"], self.K, self.B)
        self.watch = int(np.random.default_rng(
            [int(run.seed) % (1 << 64), 31]).integers(base.WATCH_CALLS))
        if run.program == "program":
            self._program_setup(tr)
        else:
            self._reference_setup()
        first = self.blocks.next()
        feed = base._WatchedFeed(self.feed, self.state)
        terms = self.call(self.state, feed, first)
        self.first = (first, feed, float(terms["loss_total"]))
        common.sync(run.device)

    def _reference_setup(self) -> None:
        run = self.run
        self.state = Trainer(run.cfg, self.weights, run.seed, run.device,
                             precision=run.program)
        self.feed = base._Rows(self)
        self.call = self._reference_call

    def window(self, seconds: float) -> dict:
        run = self.run
        calls = steps = failed = 0
        losses = []
        counted = _counters() if run.program == "program" else None
        with _Window(run.trace, run.device) as win:
            while True:
                idx = self.blocks.next()
                feed = self.feed
                if calls == self.watch:
                    feed = base._WatchedFeed(self.feed, self.state)
                with torch.profiler.record_function(CALL):
                    terms = self.call(self.state, feed, idx)
                loss = float(terms["loss_total"])
                if calls == self.watch:
                    self.watched = (idx, feed, loss)
                calls += 1
                steps += self.K
                losses.append(loss)
                failed += 0 if np.isfinite(loss) else self.K
                if calls > self.watch and win.elapsed() >= seconds:
                    break
            elapsed = win.elapsed()
        images = steps * self.B
        m = run.cfg["model"]
        notes = []
        if counted is not None:
            (bn, fuses), (bn0, fuses0) = _counters(), counted
            notes.append(f"ppn_bn_* launches {(bn - bn0) / calls:.1f} a "
                         f"call, exchange units {(fuses - fuses0) / steps:.2f}"
                         f" a step")
        obs = {"trace": win.trace, "spans": win.spans, "steps": steps,
               "images": images, "window_s": elapsed,
               "flops_per_image": flops_hrnet.train_flops(m),
               "warp_bytes_per_launch": 2 * 2 * self.B * 3
               * m["insize"][0] * m["insize"][1]}
        return {"e2e": {"train_img_per_s": images / max(elapsed, 1e-9)},
                "attempted": steps, "failed": failed, "obs": obs,
                "notes": [f"{steps} steps of {self.B} in {elapsed:.3f} s; "
                          f"first call's mean loss {self.first[2]!r}; "
                          f"window call {self.watch} watched; window "
                          f"losses {common.summary(losses)}"] + notes}

    def _follow(self, block, feed: base._WatchedFeed, resume: bool):
        run = self.run
        t = run.cfg["train"]
        wd, mu = t["weight_decay"], t["momentum"]
        s = feed.snaps
        ref = Trainer(run.cfg, self.weights, run.seed, run.device)
        if resume:
            ref.resume(s[0]["params"], s[0]["trace"], feed.count,
                       feed.generator)
        start = {n: p.clone() for n, p in ref.params.items()}
        losses, p3 = [], None
        for k, idx in enumerate(block):
            with common.no_tf32():
                terms, grads = ref.step(self._batch(idx))
            losses.append(float(terms["loss_total"]))
            if k == 0:
                g1_ref = {n: g.detach() for n, g in grads.items()}
            if k == 2:
                p3 = {n: p.clone() for n, p in ref.params.items()}
        p0, t0, t1 = s[0]["params"], s[0]["trace"], s[1]["trace"]
        g1 = {n: t1[n] - mu * t0[n] - (wd * p0[n] if t1[n].ndim > 1 else 0)
              for n in t1}
        ref_norm = {n: float(g.norm()) for n, g in g1_ref.items()}
        med = float(np.median(list(ref_norm.values())))
        moved = [n for n in g1_ref if ref_norm[n] >= base.EXCLUDE * med]
        d3 = {n: s[3]["params"][n] - p0[n] for n in moved}
        d3_ref = {n: p3[n] - start[n] for n in moved}
        grad = base._leaf_gaps(g1, g1_ref, list(g1_ref))
        change = base._leaf_gaps(d3, d3_ref, moved)
        notes = [f"{len(g1_ref) - len(moved)} leaves left out of the change",
                 f"worst gradient leaves {base._top(grad)}",
                 f"worst change leaves {base._top(change)}"]
        return ({"grad_gap": max(grad.values()),
                 "change_gap": max(change.values()),
                 "grad_gap_median": float(np.median(list(grad.values()))),
                 "change_gap_median": float(np.median(list(change.values())))},
                float(np.mean(losses)), notes)
