"""Training: the program's K-step call (``make_multi_train_step``) over a
device-resident uint8 ``DeviceCache``, augmentation on, in the
configuration's precision.

Traffic parameters: ``batch`` (B), ``steps_per_call`` (K), ``rows`` of the
cache tiled from ``renders`` renders of the seed. Every batch's rows are
drawn on the host from the seed without replacement, one (K, B) block a
call. The weights are drawn from the seed by the benchmark.

Set-up builds one train state, cache and call, and drives them through a
first call: the window's own call and feed, watched to keep the state
before the call's first step, after it and after its third. The window
then continues the same objects and watches one of its own first
``WATCH_CALLS`` calls, drawn from the seed, in the same way; it ends at
the first call boundary after ``--seconds``, and not before that call.

Checked after the window, against the reference in float32 (TF32 off),
with the same augmentation draws:
- the first call, the reference stepping the same weights through the
  same batches: the call's mean loss against the reference's mean over
  the same K steps (the call returns only that mean), the first step's
  gradient as the optimizer got it (its momentum trace's change less the
  decay) leaf by leaf, and each leaf's change over three steps;
- the watched window call (``window_`` numbers): the same gradient and
  change, the reference resuming three steps from the state kept before
  that call (the program's parameters, traces, step count and generator
  state). A fault that shows only after the first call is caught there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import harness
from perfbench.entries import common
from perfbench.reference import train as reftrain
from perfbench.yardstick.flops import train_flops
from perfbench.yardstick.trace import CALL

SNAPSHOTS = (0, 1, 3)      # states kept: before step 1, after 1, after 3
WATCH_CALLS = 4            # the watched window call is one of the first four
EXCLUDE = 1e-3             # leaves whose reference gradient is under this
                           # share of the median leaf's move by round-off


class _Collated:
    """A collated host set, as ``DeviceCache`` takes a dataset."""

    def __init__(self, host: Dict[str, np.ndarray]):
        self.host = host

    def __len__(self) -> int:
        return len(self.host["image"])

    def materialize_collated(self, image_uint8: bool = True):
        return self.host


class _Rows:
    """The control's feed: a block's rows of the renders, on the device."""

    def __init__(self, entry: "Entry"):
        self.entry = entry

    def batch(self, idx):
        return self.entry._batch(idx)


class _WatchedFeed:
    """A feed as one call sees it: keeps the stepper's steps taken and
    generator state at the call's start and, before handing out batch k,
    a copy of its parameters and traces when k is one of ``SNAPSHOTS``."""

    def __init__(self, feed, state):
        self.feed, self.state, self.calls, self.snaps = feed, state, 0, {}
        ref = isinstance(state, reftrain.Trainer)
        self.count = state.count if ref else state.step
        self.generator = state.generator.get_state()

    def batch(self, idx):
        if self.calls in SNAPSHOTS:
            self.snaps[self.calls] = _snapshot(self.state)
        self.calls += 1
        return self.feed.batch(idx)


def _snapshot(state) -> dict:
    """Parameters and traces by name, of the program's state or of the
    reference's, copied."""
    params = (state.params if isinstance(state, reftrain.Trainer)
              else dict(state.model.named_parameters()))
    return {"params": {n: p.detach().clone() for n, p in params.items()},
            "trace": {n: t.detach().clone() for n, t in state.trace.items()}}


class IndexBlocks:
    """(K, B) blocks of cache rows drawn from the seed, each batch's rows
    distinct."""

    def __init__(self, seed: int, rows: int, k: int, b: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 29])
        self.rows, self.k, self.b = rows, k, b

    def next(self) -> np.ndarray:
        return np.stack([self.rng.choice(self.rows, self.b, replace=False)
                         for _ in range(self.k)])


class Entry:
    def __init__(self, run: harness.Run):
        self.run = run
        tr = run.traffic
        self.B, self.K = tr["batch"], tr["steps_per_call"]
        self.weights = common.model_weights(run)
        self.renders = common.renders(run, tr["renders"])
        self.blocks = IndexBlocks(run.seed, tr["rows"], self.K, self.B)
        self.watch = int(np.random.default_rng(
            [int(run.seed) % (1 << 64), 31]).integers(WATCH_CALLS))
        if run.program == "program":
            self._program_setup(tr)
        else:
            self._reference_setup()
        first = self.blocks.next()
        feed = _WatchedFeed(self.feed, self.state)
        terms = self.call(self.state, feed, first)
        self.first = (first, feed, float(terms["loss_total"]))
        common.sync(run.device)

    def _program_setup(self, tr: dict) -> None:
        from ppn_tpu_torch.data.device_cache import DeviceCache
        from ppn_tpu_torch.train.steps import (create_train_state,
                                               make_multi_train_step)

        run = self.run
        pcfg = harness.program_config(run.cfg)
        host = {k: np.resize(v, (tr["rows"], *v.shape[1:]))
                for k, v in self.renders.items()}
        with torch.device(run.device):
            state = create_train_state(pcfg, seed=run.seed, device=run.device)
        state.model.load_state_dict(self.weights)
        self.feed = DeviceCache(_Collated(host), image_uint8=True,
                                device=run.device)
        del host
        self.state = state
        self.call = make_multi_train_step(pcfg, augment=True,
                                          steps_per_call=self.K)

    def _reference_setup(self) -> None:
        """The control (or a witness): the reference, in the run's
        precision, in the program's place, with a K-step call of its own."""
        run = self.run
        self.state = reftrain.Trainer(run.cfg, self.weights, run.seed,
                                      run.device, precision=run.program)
        self.feed = _Rows(self)
        self.call = self._reference_call

    @staticmethod
    def _reference_call(state, feed, idx) -> Dict[str, torch.Tensor]:
        losses = []
        for i in np.asarray(idx):
            with common.no_tf32():
                terms, _ = state.step(feed.batch(i))
            losses.append(terms["loss_total"])
        return {"loss_total": torch.stack(losses).mean()}

    def _batch(self, idx) -> Dict[str, torch.Tensor]:
        rows = np.asarray(idx) % len(self.renders["image"])
        return {k: torch.from_numpy(v[rows]).to(self.run.device)
                for k, v in self.renders.items()}

    def window(self, seconds: float) -> dict:
        run = self.run
        calls = steps = failed = 0
        losses = []
        with common.Window(run.trace, run.device) as win:
            while True:
                idx = self.blocks.next()
                feed = self.feed
                if calls == self.watch:
                    feed = _WatchedFeed(self.feed, self.state)
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
        obs = {"trace": win.trace, "steps": steps, "images": images,
               "window_s": elapsed, "flops_per_image": train_flops(m),
               "warp_bytes_per_launch": 2 * 2 * self.B * 3
               * m["insize"][0] * m["insize"][1]}
        return {"e2e": {"train_img_per_s": images / max(elapsed, 1e-9)},
                "attempted": steps, "failed": failed, "obs": obs,
                "notes": [f"{steps} steps of {self.B} in {elapsed:.3f} s; "
                          f"first call's mean loss {self.first[2]!r}; "
                          f"window call {self.watch} watched; window "
                          f"losses {common.summary(losses)}"]}

    def release(self) -> None:
        self.state = self.call = self.feed = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        block, feed, loss = self.first
        first, ref_loss, notes = self._follow(block, feed, resume=False)
        block, feed, _ = self.watched
        later, _, later_notes = self._follow(block[:max(SNAPSHOTS)], feed,
                                             resume=True)
        self.notes = [f"reference mean loss {ref_loss!r}, program "
                      f"{loss!r}"] + notes + [f"window call {self.watch}: "
                                              f"{n}" for n in later_notes]
        return {"loss_gap": abs(loss - ref_loss) / abs(ref_loss), **first,
                **{f"window_{k}": v for k, v in later.items()}}

    def _follow(self, block, feed: _WatchedFeed, resume: bool):
        """The reference over ``block`` from the weights, or resuming from
        the state ``feed`` kept at its call's start; the gradient and change
        gaps against what ``feed`` kept, its mean loss and notes."""
        run = self.run
        t = run.cfg["train"]
        wd, mu = t["weight_decay"], t["momentum"]
        s = feed.snaps
        ref = reftrain.Trainer(run.cfg, self.weights, run.seed, run.device)
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
        moved = [n for n in g1_ref if ref_norm[n] >= EXCLUDE * med]
        d3 = {n: s[3]["params"][n] - p0[n] for n in moved}
        d3_ref = {n: p3[n] - start[n] for n in moved}
        grad = _leaf_gaps(g1, g1_ref, list(g1_ref))
        change = _leaf_gaps(d3, d3_ref, moved)
        notes = [f"{len(g1_ref) - len(moved)} leaves left out of the change",
                 f"worst gradient leaves {_top(grad)}",
                 f"worst change leaves {_top(change)}"]
        return ({"grad_gap": max(grad.values()),
                 "change_gap": max(change.values()),
                 "grad_gap_median": float(np.median(list(grad.values()))),
                 "change_gap_median": float(np.median(list(change.values())))},
                float(np.mean(losses)), notes)

    def obs_after_check(self) -> dict:
        return {}


def _leaf_gaps(got: dict, want: dict, names: list) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    gn = {n: float(got[n].float().norm()) for n in names}
    wn = {n: float(want[n].float().norm()) for n in names}
    med = float(np.median(list(wn.values())))
    return {n: abs(gn[n] - wn[n]) / max(wn[n], med) for n in names}


def _top(gaps: Dict[str, float], k: int = 4) -> str:
    return ", ".join(f"{n} {v:.4g}" for n, v in
                     sorted(gaps.items(), key=lambda kv: -kv[1])[:k])
