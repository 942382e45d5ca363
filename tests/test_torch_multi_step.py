"""The port's K-step training loop (ppn_tpu_torch/train/steps.py
make_multi_train_step and the Trainer's block loop) on the CPU: the cases
of tests/test_multi_step.py on tiny_test.

The port runs K ``train_step`` bodies over ``DeviceCache`` gathers, the
same calls in the same order, so K steps per call are held **bitwise**
against K ``train_step`` calls at K = 1, 2 and 4, with augmentation on
(where the JAX package's scan is bitwise only at K=1). On a CUDA device
the call replays a CUDA graph of the step instead
(tests/test_torch_graph_cuda.py); here it dispatches to the eager steps,
and the update that the graph runs, with the learning rate read from a
tensor, is held bitwise the scalar form. Against the JAX
package's ``make_multi_train_step``, with augmentation off and f32 compute
from the same state (tests/test_torch_train.py's per-step parity): at K=1
and lr 0.05 the loss terms and grad_norm within rel 1e-4 and the new
BatchNorm statistics within 1e-4·max; at K=2 the lr is 1e-4, at which the
two frameworks' first steps, whose f32 gradients differ by rounding, leave
parameters close enough that the mean terms meet the same 1e-4 (worst
2.4e-5, loss_size; at lr 1e-3 grad_norm parts by 1.1e-3: the noise
images' gradient norm is ~1,100, so one step moves the parameters far).
The Trainer's index blocks, and the steps at which it logs, checkpoints
and evaluates, equal the JAX trainer's on the same cadences (its steps
stubbed, so nothing is compiled). The two-rank cases (the sharded cache
feeding the K-step loop, and the Trainer on a data mesh) run in the
two-rank world of tests/test_torch_parallel.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.device_cache import DeviceCache as JaxDeviceCache
from ppn_tpu.train import steps as jst
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.device_cache import DeviceCache
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.trainer import Trainer
from ppn_tpu_torch.utils.params_io import jax_leaves_from_state_dict

from test_torch_train import _batches, _cfgs, _jax_leaves, _load_jax_state
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(**train):
    """tiny_test at B=2 with EMA, a constant lr of 0.05 from the first step
    (so every step moves the parameters)."""
    cfg = get_config("tiny_test")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, ema_decay=0.99, lr_schedule="constant",
        warmup_steps=0, learning_rate=0.05, **train))


def _assert_same_state(a, b):
    """The whole train state bitwise: parameters, BatchNorm statistics,
    momentum traces, EMA, step and the augmentation generator."""
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for tree_a, tree_b in ((sa, sb), (a.trace, b.trace), (a.ema, b.ema)):
        assert tree_a.keys() == tree_b.keys()
        for k, v in tree_a.items():
            assert torch.equal(v, tree_b[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_multi_step_is_bitwise_k_train_steps(k):
    """tests/test_multi_step.py:27 and :92 (K=1 bitwise; K=4 within 1e-3
    there): K steps per call against K ``train_step`` calls on the same
    gathered batches, augmentation on — the whole state and the terms
    averaged over K, bitwise."""
    cfg = _cfg(steps_per_call=k)
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=6, seed=0),
                        device="cpu")
    a = st.create_train_state(cfg, device="cpu")
    b = st.create_train_state(cfg, device="cpu")
    start = {n: p.detach().clone() for n, p in a.model.named_parameters()}
    idx = (np.arange(2 * k, dtype=np.int32).reshape(k, 2) * 5) % 6
    per_step = [st.train_step(cfg, a, cache.batch(i), augment=True)
                for i in idx]
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=k)
    got = multi(b, cache, idx)
    _assert_same_state(a, b)
    assert b.step == k
    assert got.keys() == per_step[0].keys() and "grad_norm" in got
    for name, v in got.items():
        assert v.shape == () and torch.equal(
            v, torch.stack([t[name] for t in per_step]).mean(0)), name
    moved = max(float((p.detach() - start[n]).abs().max())
                for n, p in b.model.named_parameters())
    assert moved > 1e-3, moved


def test_multi_step_carry_is_bitwise():
    """tests/test_multi_step.py:57: one call of K=4 against four calls of
    K=1 on the rows of the same block, the whole state bitwise; a block of
    the wrong shape is refused."""
    cfg = _cfg()
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=6, seed=0),
                        device="cpu")
    a = st.create_train_state(cfg, device="cpu")
    b = st.create_train_state(cfg, device="cpu")
    idx = np.arange(8, dtype=np.int32).reshape(4, 2) % 6
    m1 = st.make_multi_train_step(cfg, steps_per_call=1)
    for i in idx:
        m1(a, cache, i[None])
    st.make_multi_train_step(cfg, steps_per_call=4)(b, cache, idx)
    _assert_same_state(a, b)
    with pytest.raises(ValueError, match="expected \\(1, batch\\)"):
        m1(a, cache, idx)
    with pytest.raises(ValueError, match=">= 1"):
        st.make_multi_train_step(cfg, steps_per_call=0)


def test_multi_step_on_the_cpu_runs_every_step_eagerly():
    """A CPU state takes the eager path: each step of a call is one
    ``train_step`` (``EAGER_STEPS`` rises by K a call) and no CUDA graph is
    captured or replayed."""
    cfg = _cfg(steps_per_call=2)
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=6, seed=0),
                        device="cpu")
    state = st.create_train_state(cfg, device="cpu")
    before = st.EAGER_STEPS, st.GRAPH_CAPTURES, st.GRAPH_REPLAYS
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=2)
    idx = np.arange(4, dtype=np.int32).reshape(2, 2)
    for _ in range(2):
        multi(state, cache, idx)
    after = st.EAGER_STEPS, st.GRAPH_CAPTURES, st.GRAPH_REPLAYS
    assert [b - a for a, b in zip(before, after)] == [4, 0, 0]
    assert state.step == 4


@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
def test_update_reading_the_lr_from_a_tensor_is_bitwise(schedule):
    """``apply_update`` with the negated learning rate in a 0-d f32 tensor
    (what the CUDA graph reads at each replay) against ``sgd_update``'s
    scalar, over three steps with the same gradients: steps 1–3 at warm-up
    2 and 5 steps cross the warm-up's end, and take the step schedule's
    first decay (at 0.6 · 5 − 2 = 1 step after it) and the cosine's
    descent. Parameters, traces and EMA bitwise."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_schedule=schedule, warmup_steps=2, num_steps=5))
    a = st.create_train_state(cfg, device="cpu")
    b = st.create_train_state(cfg, device="cpu")
    a.step = b.step = 1
    schedule_at = st.make_lr_schedule(cfg)
    lrs = [schedule_at(s) for s in (1, 2, 3)]
    assert 0 < lrs[0] < lrs[1], lrs
    assert (lrs[2] == lrs[1]) == (schedule == "constant"), lrs
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in a.model.named_parameters()}
        st.sgd_update(cfg, a, grads)
        neg_lr = torch.tensor(-schedule_at(b.step), dtype=torch.float32)
        st.apply_update(cfg, b, grads, neg_lr)
        b.step += 1
    _assert_same_state(a, b)
    assert a.step == 4


class _Rows:
    """A map-style dataset over the rows of collated batches."""

    def __init__(self, batches):
        self.rows = [{k: v[i] for k, v in b.items()}
                     for b in batches for i in range(len(b["image"]))]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return dict(self.rows[i])


@pytest.mark.parametrize("k,lr", [(1, 0.05), (2, 1e-4)])
def test_multi_step_matches_jax(k, lr):
    """``make_multi_train_step`` against the JAX package's, f32, augmentation
    off, the same state and the same noise-image cache (the module
    docstring gives the tolerances and why lr is 1e-4 at K=2)."""
    jcfg, cfg = _cfgs(dtype="float32", lr_schedule="constant",
                      warmup_steps=0, learning_rate=lr, ema_decay=0.9,
                      batch_size=2, steps_per_call=k)
    graphdef, jstate, tx = jst.create_train_state(jcfg)
    state = st.create_train_state(cfg, device="cpu")
    _load_jax_state(cfg, state, jstate)
    rows = _Rows(_batches(jcfg, k))
    idx = np.arange(2 * k, dtype=np.int32).reshape(k, 2)[:, ::-1].copy()
    jmulti = jst.make_multi_train_step(jcfg, graphdef, tx, augment=False,
                                       steps_per_call=k)
    jstate, want = jmulti(jstate, JaxDeviceCache(rows).data,
                          jnp.asarray(idx), None)
    got = st.make_multi_train_step(cfg, augment=False, steps_per_call=k)(
        state, DeviceCache(rows, device="cpu"), idx)
    assert state.step == int(jstate.step) == k
    assert set(got) == set(want)
    for name in want:
        w, g = float(want[name]), float(got[name])
        assert abs(g - w) <= 1e-4 * abs(w), (name, g, w)
    jl = _jax_leaves(jstate)
    tl = jax_leaves_from_state_dict(state.model.state_dict(), state.model)
    n_params = len(jax.tree.leaves(jstate.params))
    for a, b in zip(jl[n_params:], tl[n_params:]):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


# ---- the Trainer's block loop ----------------------------------------------

def test_index_blocks_equal_the_jax_trainers():
    """``_index_blocks`` draws the JAX trainer's blocks exactly: shuffled
    epochs over a dataset of 7 at B=2, K=3 (the remainder of each epoch
    dropped, blocks spanning epochs), and with replacement below one
    batch."""
    from ppn_tpu.train.trainer import Trainer as JaxTrainer

    for size, B in ((7, 2), (3, 4)):
        ours = Trainer.__new__(Trainer)
        ours.device_cache = type("C", (), {"size": size})()
        theirs = JaxTrainer.__new__(JaxTrainer)
        theirs.device_cache = ours.device_cache
        a, b = ours._index_blocks(B, 3, 11), theirs._index_blocks(B, 3, 11)
        for _ in range(5):
            x, y = next(a), next(b)
            assert x.dtype == y.dtype == np.int32 and x.shape == (3, B)
            np.testing.assert_array_equal(x, y)


def _cadence_cfg(name, tmp_path, **train):
    cfg = (get_config if name == "port" else jax_get_config)("tiny_test")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, steps_per_call=3, log_every=2,
        checkpoint_every=4, eval_every=5, resume=False,
        checkpoint_dir=str(tmp_path / name / "ckpt"), **train))


def test_trainer_block_loop_runs_and_counts(tmp_path):
    """tests/test_multi_step.py:209: K=3 over 10 steps is three blocks and
    one per-step step; the index blocks and the steps that log,
    checkpoint and evaluate are the JAX trainer's (its steps stubbed to
    advance the count: the cadence is the host loop's), with the cadences
    rounded to block boundaries: logs at 3, 6, 9, 10, checkpoints at 6, 9
    and the final 10, evals at 6 and 10."""
    from ppn_tpu.train.trainer import Trainer as JaxTrainer

    seen = {}
    runs = {}
    for name in ("port", "jax"):
        cfg = _cadence_cfg(name, tmp_path)
        logdir = str(tmp_path / name)
        blocks, saves, evals = [], [], []
        if name == "port":
            ds = SyntheticPoseDataset(cfg, size=6, seed=0)
            cache = DeviceCache(ds, device="cpu")
            trainer = Trainer(cfg, cache.infinite_batches(2, seed=0),
                              val_dataset=ds, logdir=logdir,
                              device_cache=cache, device="cpu")
            multi = trainer.multi_step

            def record(state, cache_, idx, multi=multi, blocks=blocks):
                blocks.append(np.asarray(idx))
                return multi(state, cache_, idx)
            trainer.multi_step = record
        else:
            ds = SyntheticPoseDataset(cfg, size=6, seed=0)
            cache = JaxDeviceCache(ds)
            trainer = JaxTrainer(cfg, cache.infinite_batches(2, seed=0),
                                 val_dataset=ds, logdir=logdir,
                                 use_mesh=False, device_cache=cache)
            terms = {"loss_total": jnp.float32(1.0)}

            def fake_multi(state, data, idx, sharding, blocks=blocks):
                blocks.append(np.asarray(idx))
                return dataclasses.replace(
                    state, step=state.step + len(idx)), terms

            def fake_step(state, batch):
                return dataclasses.replace(state, step=state.step + 1), terms
            trainer.multi_step, trainer.train_step = fake_multi, fake_step
        trainer.ckpt.save = lambda step, state, saves=saves: saves.append(
            step)
        trainer.evaluate = lambda evals=evals, tr=trainer: evals.append(
            tr.step) or {}
        final = trainer.run(10)
        assert trainer.step == 10
        trainer.close()
        with open(os.path.join(logdir, "train_metrics.jsonl")) as fh:
            logged = [json.loads(line)["step"] for line in fh]
        seen[name] = (logged, saves, evals)
        runs[name] = (blocks, final)
    assert seen["port"] == seen["jax"] == (
        [3, 6, 6, 9, 10, 10], [6, 9, 10], [6, 10]), seen
    (ours, final), (theirs, _) = runs["port"], runs["jax"]
    assert len(ours) == len(theirs) == 3
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)
    assert np.isfinite(final["loss_total"])
