"""The K-step call's CUDA graph (``train/steps.py`` ``_StepGraph``) on the
card: replayed steps against eager ``train_step`` calls.

Needs an NVIDIA GPU with nvcc; without one every test here skips. Run on
the card with ``python -m pytest --noconftest tests/test_torch_graph_cuda.py``
(the repo's conftest imports JAX, which the GPU machine does not need).

A replay runs the eager step's kernels in the same order on the same
arithmetic, so everything is held bitwise: parameters, momentum traces,
EMA, BatchNorm statistics, the generator's state, the step count and the
mean loss terms. cuDNN is held to its deterministic algorithms here, so
that an eager step is bitwise another eager step at these small shapes.
The configurations are ``tiny_test`` (64² input) on ResNet-18 and on
HRNet-W32, in bf16 with augmentation and EMA, under a cosine schedule with
a warm-up, so that every step has a learning rate of its own.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.device_cache import DeviceCache
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.utils.profiling import kernel_records
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.cuda,
              pytest.mark.usefixtures("one_torch_thread")]

K, B, ROWS = 4, 4, 16
KERNELS = ("ppn_bn_", "ppn_warp_kernel")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _cfg(backbone="resnet18"):
    cfg = get_config("tiny_test")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=backbone),
        train=dataclasses.replace(
            cfg.train, batch_size=B, steps_per_call=K, ema_decay=0.99,
            lr_schedule="cosine", warmup_steps=2, num_steps=12,
            learning_rate=0.05))


def _blocks(n, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return [np.stack([rng.choice(ROWS, batch, replace=False)
                      for _ in range(K)]).astype(np.int32)
            for _ in range(n)]


def _counters():
    return st.EAGER_STEPS, st.GRAPH_CAPTURES, st.GRAPH_REPLAYS


def _since(before):
    return [b - a for a, b in zip(before, _counters())]


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for tree_a, tree_b in ((sa, sb), (a.trace, b.trace), (a.ema, b.ema)):
        assert tree_a.keys() == tree_b.keys()
        for n, v in tree_a.items():
            assert torch.equal(v, tree_b[n]), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _pair(cfg, dev):
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=ROWS, seed=0),
                        device=dev)
    return cache, (st.create_train_state(cfg, device=dev),
                   st.create_train_state(cfg, device=dev))


def _eager_call(cfg, state, cache, block):
    terms = [st.train_step(cfg, state, cache.batch(i), augment=True)
             for i in block]
    return {n: torch.stack([t[n] for t in terms]).mean(0) for n in terms[0]}


@pytest.mark.parametrize("backbone", ["resnet18", "hrnet_w32"])
def test_replayed_steps_are_bitwise_eager_steps(device, backbone):
    """Two K=4 calls (one eager step, a capture, seven replays) against
    eight ``train_step`` calls on the same batches: the whole state and
    each call's mean terms bitwise, and in a profiler trace of the second
    call, all replays, as many ``ppn_bn_*`` and ``ppn_warp_kernel`` kernels
    as the eager steps run."""
    cfg = _cfg(backbone)
    cache, (a, b) = _pair(cfg, device)
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=K)
    first, second = _blocks(2)
    before = _counters()
    got = [multi(a, cache, first)]
    out, replayed = kernel_records(multi, a, cache, second, names=KERNELS)
    got.append(out)
    graph = _since(before)
    want = [_eager_call(cfg, b, cache, first)]
    out, eager = kernel_records(_eager_call, cfg, b, cache, second,
                                names=KERNELS)
    want.append(out)
    _assert_same_state(a, b)
    assert a.step == 2 * K
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and "grad_norm" in g
        for n in w:
            assert torch.equal(g[n], w[n]), n
    assert graph == [1, 1, 2 * K - 1], graph
    assert replayed == eager, (replayed, eager)
    assert eager["ppn_warp_kernel"] == K and eager["ppn_bn_"] > 0


def test_the_feed_is_called_once_a_step_in_order(device):
    """A feed wrapper, as the benchmark's, sees ``batch`` once a step in
    the block's order, with the state advanced by the steps before: the
    parameters it sees before step k are the eager run's after k steps."""
    cfg = _cfg()
    cache, (a, b) = _pair(cfg, device)
    name = "head.out.weight"
    eager = []
    for blk in _blocks(2):
        for i in blk:
            eager.append(b.model.get_parameter(name).detach().clone())
            st.train_step(cfg, b, cache.batch(i), augment=True)

    class Feed:
        def __init__(self):
            self.seen = []

        def batch(self, idx):
            self.seen.append((a.step, np.asarray(idx).copy(),
                              a.model.get_parameter(name).detach().clone()))
            return cache.batch(idx)

    feed = Feed()
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=K)
    rows = []
    for blk in _blocks(2):
        multi(a, feed, blk)
        rows += list(blk)
    assert [s for s, _, _ in feed.seen] == list(range(2 * K))
    for (_, idx, p), row, want in zip(feed.seen, rows, eager):
        np.testing.assert_array_equal(idx, row)
        assert torch.equal(p, want)
    _assert_same_state(a, b)


def test_capture_follows_the_state_and_the_batch(device):
    """An in-place ``load_state_dict`` keeps the graph; a replaced trace, a
    new state object or a batch of another size is captured anew (one
    eager step, then replays), and each stays bitwise its eager twin.
    Dropping the call frees the graph's memory pool."""
    cfg = _cfg()
    cache, (a, b) = _pair(cfg, device)
    multi = st.make_multi_train_step(cfg, augment=True, steps_per_call=K)
    blk, blk2, blk3, blk4 = _blocks(4)

    def both(block, expect):
        before = _counters()
        multi(a, cache, block)
        assert _since(before) == expect, (_since(before), expect)
        _eager_call(cfg, b, cache, block)
        _assert_same_state(a, b)

    both(blk, [1, 1, K - 1])
    sd = {n: v.clone() for n, v in b.model.state_dict().items()}
    a.model.load_state_dict(sd)
    both(blk2, [0, 0, K])                       # copied in place: replays
    name = next(iter(a.trace))
    a.trace[name] = a.trace[name].clone()
    both(blk3, [1, 1, K - 1])                   # a tensor replaced
    small = _blocks(1, seed=5, batch=B // 2)[0]
    both(small, [1, 1, K - 1])                  # another batch size
    both(blk4, [1, 1, K - 1])                   # ... and back
    c = st.create_train_state(cfg, device=device)
    before = _counters()
    multi(c, cache, blk)
    assert _since(before) == [1, 1, K - 1]     # another state
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved()
    del multi
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held
