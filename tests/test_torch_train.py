"""The port's training slice against the JAX package: BatchNorm in
training mode, the lr schedules, the train step, the optimizer and EMA,
checkpoints, snapshots, the device cache's sampling order and the CLI.

Train-step parity. The JAX state of tiny_test (f32 compute) is carried into
the port through state_dict_from_jax_leaves; both take steps with
augmentation off, a constant lr of 0.05 and ema_decay 0.9 on seeded uint8
noise images with synthetic GT. Before each step the port's parameters and
BatchNorm statistics are set to JAX's, so each step starts from the same
state; the loss terms, grad_norm and the new BatchNorm statistics must
then agree within rel 1e-4. The parameters after a step are not compared
there: at lr 0.05 they move by lr·grad, and f32 gradients of this model
are only good to about 1% on some leaves in either framework (against a
float64 evaluation, the BatchNorm backward cancels), so two f32 programs
of the same math part by more than 1e-4·max|p| within a step. The test
prints how far the port running free, and JAX on each batch in reversed
order, end from JAX. The update itself is held separately: the port's
optimizer and EMA, given the gradients optax is given, track optax within
1e-6·max|p| over three steps.

The noise images matter: the synthetic renders are mostly flat black, which
leaves near-constant channels in the small tiny_test feature maps and makes
even the first step's gradient ill-conditioned (grad_norm 1.1e-4 apart).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.device_cache import DeviceCache as JaxDeviceCache
from ppn_tpu.data.pipeline import collate
from ppn_tpu.data.synthetic import SyntheticPoseDataset
from ppn_tpu.train import steps as jst
from ppn_tpu.utils.params_io import load_inference_npz as jax_load_npz
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.device_cache import DeviceCache
from ppn_tpu_torch.nn.resnet import BatchNorm
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.trainer import Trainer
from ppn_tpu_torch.utils.params_io import (jax_leaves_from_state_dict,
                                           load_npz_into_train_state,
                                           save_inference_npz,
                                           state_dict_from_jax_leaves)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH_KEYS = ("image", "keypoints", "visible", "bboxes", "valid")


def _cfgs(name="tiny_test", **train):
    jcfg, cfg = jax_get_config(name), get_config(name)
    return (dataclasses.replace(jcfg, train=dataclasses.replace(
                jcfg.train, **train)),
            dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, **train)))


def _batches(cfg, n, B=2, noise=True):
    """n batches of synthetic GT; the images seeded uint8 noise."""
    ds = SyntheticPoseDataset(cfg, size=n * B, seed=1)
    out = []
    for i in range(n):
        b = collate([ds[B * i + j] for j in range(B)], image_uint8=True)
        b.pop("headsizes", None)
        if noise:
            b["image"] = np.random.default_rng(i).integers(
                0, 256, b["image"].shape, dtype=np.uint8)
        out.append(b)
    return out


def _jax_leaves(state):
    return [np.asarray(x) for x in
            jax.tree.leaves({"params": state.params, "rest": state.rest})]


def _numpy_leaves(shapes, seed=1):
    """Seeded weights for the JAX model's {"params", "rest"} leaves, as
    tests/test_torch_model.py makes them: He-scaled kernels, BatchNorm
    scale and var in [0.5, 1.5], biases and means N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, leaf in shapes:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        name = keys[-2] if keys[-1] == "value" else keys[-1]
        if name == "kernel":
            a = rng.normal(0.0, np.sqrt(2.0 / np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = rng.normal(0.0, 0.1, leaf.shape)
        leaves.append(a.astype(np.float32))
    return leaves


def _load_jax_state(cfg, state, jstate):
    state.model.load_state_dict(
        state_dict_from_jax_leaves(cfg, _jax_leaves(jstate), state.model))


# ---- BatchNorm in training mode --------------------------------------------

@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16)])
def test_batchnorm_training_matches_flax(tdtype, jdtype):
    """Inputs 96 + k/4 over 64 values per channel: every sum is exact in
    f32 whatever its order, and the mean is exact, so both frameworks
    compute the same statistics; only mean² rounds, which is what the fast
    variance E[x²] − E[x]² shows against the exact one."""
    rng = np.random.default_rng(0)
    C = 8
    x = (96.0 + rng.integers(-8, 9, (4, 4, 4, C)) / 4.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.1, C).astype(np.float32)
    mean0 = rng.normal(0, 0.1, C).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)

    bn = nnx.BatchNorm(C, momentum=0.9, epsilon=1e-5,
                       use_running_average=False, dtype=jdtype,
                       param_dtype=jnp.float32, rngs=nnx.Rngs(0))
    bn.scale[...], bn.bias[...] = scale, bias
    bn.mean[...], bn.var[...] = mean0, var0
    want = np.asarray(bn(jnp.asarray(x).astype(jdtype)), np.float32)

    tbn = BatchNorm(C, dtype=tdtype).train()
    with torch.no_grad():
        for t, a in ((tbn.weight, scale), (tbn.bias, bias),
                     (tbn.running_mean, mean0), (tbn.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    got = tbn(torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(bn.mean[...]), rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(bn.var[...]), rtol=1e-6)
    # a two-pass (or unbiased) variance would be caught: the fast one is
    # visibly off the exact biased variance here
    xr = torch.from_numpy(x).to(tdtype).double().numpy()
    exact = 0.9 * var0.astype(np.float64) + 0.1 * xr.var(axis=(0, 1, 2))
    assert np.abs(tbn.running_var.numpy() - exact).max() > 1e-5
    tbn.eval()   # eval mode reads the running statistics: no update
    before = tbn.running_var.clone()
    tbn(torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2))
    assert torch.equal(before, tbn.running_var)


# ---- the lr schedules ---------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "constant", "step"])
def test_lr_schedule_matches_optax(schedule):
    jcfg, cfg = _cfgs(lr_schedule=schedule, warmup_steps=5, num_steps=40,
                      learning_rate=0.05)
    want = jst.make_lr_schedule(jcfg)
    got = st.make_lr_schedule(cfg)
    for step in range(40):
        w, g = float(want(step)), got(step)
        assert abs(g - w) <= 1e-6 * abs(w), (step, g, w)
    assert got(0) == 0.0   # the first step is taken at sched(0)


# ---- the train step -------------------------------------------------------------

def _spread(ref, state=None, other=None):
    """max |Δp| / max |p| over the parameters, against the JAX state
    ``ref``: of a port state, or of another JAX state."""
    want = [np.asarray(x) for x in jax.tree.leaves(ref.params)]
    if other is not None:
        got = [np.asarray(x) for x in jax.tree.leaves(other.params)]
    else:
        got = jax_leaves_from_state_dict(state.model.state_dict(),
                                         state.model)[:len(want)]
    return (max(np.abs(a - b).max() for a, b in zip(want, got))
            / max(np.abs(a).max() for a in want))


def test_train_step_matches_jax_from_the_same_state(capsys):
    jcfg, cfg = _cfgs(dtype="float32", lr_schedule="constant",
                      warmup_steps=0, learning_rate=0.05, ema_decay=0.9)
    graphdef, jstate, tx = jst.create_train_state(jcfg)
    jstep = jst.make_train_step(jcfg, graphdef, tx, augment=False)
    state = st.create_train_state(cfg, device="cpu")
    # beside the assertions, for the record: the port left to run free
    # from the same start, and JAX on each batch in reversed order (the
    # same math, other rounding), both against JAX
    free = st.create_train_state(cfg, device="cpu")
    _load_jax_state(cfg, free, jstate)
    swapped = jax.tree.map(jnp.copy, jstate)
    for k, batch in enumerate(_batches(jcfg, 3)):
        _load_jax_state(cfg, state, jstate)
        jstate, want = jstep(jstate, batch)
        got = st.train_step(cfg, state, batch)
        free_terms = st.train_step(cfg, free, batch)
        swapped, _ = jstep(swapped, {n: v[::-1].copy()
                                     for n, v in batch.items()})
        assert state.step == int(jstate.step) == k + 1
        assert set(got) == set(want)
        for name in want:
            w, g = float(want[name]), float(got[name])
            assert abs(g - w) <= 1e-4 * abs(w), (k, name, g, w)
        # the BatchNorm statistics the step wrote
        jl = _jax_leaves(jstate)
        tl = jax_leaves_from_state_dict(state.model.state_dict(),
                                        state.model)
        n_params = len(jax.tree.leaves(jstate.params))
        for a, b in zip(jl[n_params:], tl[n_params:]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
        if k == 2:   # the loss with running statistics, no state change
            _load_jax_state(cfg, state, jstate)
            want = jst.make_eval_loss_step(jcfg, graphdef)(jstate, batch)
            before = {n: t.clone() for n, t in state.model.state_dict().items()}
            got = st.eval_loss_step(cfg, state, batch)
            for name in want:
                w, g = float(want[name]), float(got[name])
                assert abs(g - w) <= 1e-4 * abs(w), ("eval", name, g, w)
            after = state.model.state_dict()
            assert all(torch.equal(before[n], after[n]) for n in before)
            assert state.model.training and state.step == 3
        with capsys.disabled():
            print(f"\n[parity] step {k + 1}: free-running port vs JAX "
                  f"params {_spread(jstate, free):.3g}·max|p|, loss_total "
                  f"rel {abs(float(free_terms['loss_total']) - float(want['loss_total'])) / float(want['loss_total']):.3g}; "
                  f"JAX on the reversed batch vs JAX params "
                  f"{_spread(jstate, other=swapped):.3g}·max|p|")


def test_train_step_bf16_first_step_matches_jax():
    """bf16 compute, the first step's loss terms (the training-mode forward
    of the JAX model, jitted): XLA keeps some intermediates in f32 where
    PyTorch rounds, so they agree to 2e-2 rel."""
    from ppn_tpu.nn.model import PoseProposalNet as JaxPPN
    from ppn_tpu.ops import encode as jenc
    from ppn_tpu.train.loss import ppn_loss as jax_ppn_loss

    jcfg, cfg = _cfgs(lr_schedule="constant", warmup_steps=0,
                      learning_rate=0.05)
    graphdef, params, rest = nnx.split(nnx.eval_shape(
        lambda: JaxPPN(jcfg.model, dtype=jnp.bfloat16, rngs=nnx.Rngs(0))),
        nnx.Param, ...)
    shapes, treedef = jax.tree_util.tree_flatten_with_path(
        {"params": params, "rest": rest})
    leaves = _numpy_leaves(shapes)
    tree = jax.tree.unflatten(treedef, leaves)
    batch = _batches(jcfg, 1)[0]

    @jax.jit
    def jax_terms(params, rest, batch):
        model = nnx.merge(graphdef, params, rest)
        model.train()
        t = jenc.encode_batch(jcfg.model, batch["keypoints"],
                              batch["visible"], batch["bboxes"],
                              batch["valid"])
        return jax_ppn_loss(jcfg.model, model(batch["image"]), t)[1]

    want = jax_terms(tree["params"], tree["rest"], batch)
    state = st.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax_leaves(cfg, leaves, state.model))
    got = st.train_step(cfg, state, batch)
    for name in want:
        w, g = float(want[name]), float(got[name])
        assert abs(g - w) <= 2e-2 * abs(w), (name, g, w)


def test_sgd_update_tracks_optax():
    """Masked weight decay, momentum, a warmup + cosine schedule and the
    EMA, given the same gradients as optax, over three steps, on a conv
    (decayed) and a BatchNorm (not decayed)."""
    from ppn_tpu_torch.nn.resnet import ConvBN

    jcfg, cfg = _cfgs(dtype="float32", warmup_steps=1, num_steps=4,
                      learning_rate=0.05, ema_decay=0.9)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ConvBN(3, 8, 3)
    ps = dict(model.named_parameters())
    state = st.TrainState(
        model=model, trace={n: torch.zeros_like(p) for n, p in ps.items()},
        ema={n: p.detach().clone() for n, p in ps.items()}, step=0,
        generator=torch.Generator())
    params = {n: p.detach().numpy().copy() for n, p in ps.items()}
    tx = jst.make_optimizer(jcfg)
    opt = tx.init(params)
    ema = dict(params)
    d = jcfg.train.ema_decay

    @jax.jit
    def reference(grads, opt, params, ema):   # steps.py's update and EMA
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), ema, params)
        return opt, params, ema

    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = {n: rng.normal(0, 1, p.shape).astype(np.float32)
                 for n, p in params.items()}
        opt, params, ema = reference(grads, opt, params, ema)
        st.sgd_update(cfg, state, {n: torch.from_numpy(g)
                                   for n, g in grads.items()})
    trace = optax.tree_utils.tree_get(opt, "trace")
    scale = max(np.abs(np.asarray(p)).max() for p in params.values())
    for n, p in model.named_parameters():
        for got, want in ((p, params[n]), (state.ema[n], ema[n]),
                          (state.trace[n], trace[n])):
            assert np.abs(got.detach().numpy() - np.asarray(want)).max() \
                <= 1e-6 * scale, n
    assert state.step == 3


# ---- checkpoints, snapshots, the device cache -------------------------------

def _run(cfg, batches, ckpt_dir, steps):
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(ckpt_dir)))
    trainer = Trainer(cfg, iter(batches), augment=True, device="cpu")
    trainer.run(steps)
    trainer.close()
    return trainer.state


def test_resume_is_bitwise_equal_to_one_run(tmp_path):
    """5 steps, a new Trainer resuming from the checkpoint, 5 more: the
    same model, traces, EMA and generator as 10 steps in one run, with the
    augmentation's draws continuing from the restored generator."""
    _, cfg = _cfgs(ema_decay=0.9, warmup_steps=2, learning_rate=0.05)
    batches = _batches(get_config("tiny_test"), 10, noise=False)
    one = _run(cfg, batches, tmp_path / "one", 10)
    _run(cfg, batches[:5], tmp_path / "two", 5)
    two = _run(cfg, batches[5:], tmp_path / "two", 10)
    assert one.step == two.step == 10
    sa, sb = one.model.state_dict(), two.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(one.trace[k], two.trace[k]) for k in one.trace)
    assert all(torch.equal(one.ema[k], two.ema[k]) for k in one.ema)
    assert torch.equal(one.generator.get_state(), two.generator.get_state())
    assert sorted(os.listdir(tmp_path / "two")) == [
        "ckpt_00000005.pt", "ckpt_00000010.pt"]
    # EMA switched on for a run that resumes an EMA-less checkpoint: seeded
    # from the restored parameters
    off = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.0, checkpoint_dir=str(tmp_path / "three")))
    Trainer(off, iter(batches), device="cpu").run(2)
    on = Trainer(dataclasses.replace(off, train=dataclasses.replace(
        off.train, ema_decay=0.9)), iter(batches), device="cpu")
    assert on.step == 2 and on.state.ema is not None
    for n, p in on.state.model.named_parameters():
        assert torch.equal(on.state.ema[n], p.detach())


def test_snapshot_loads_in_jax(tmp_path):
    """A port-trained snapshot (EMA parameters + BatchNorm statistics) loads
    into the JAX package; both eval forwards agree within
    test_torch_model.py's bf16 tolerance (3e-2 of the largest logit)."""
    jcfg, cfg = _cfgs(ema_decay=0.5, warmup_steps=0, learning_rate=0.01)
    state = st.create_train_state(cfg, device="cpu")
    for batch in _batches(jcfg, 2):
        st.train_step(cfg, state, batch)
    path = str(tmp_path / "snap.npz")
    n = save_inference_npz(path, state)
    graphdef, jstate = jax_load_npz(jcfg, path)
    assert n == len(_jax_leaves(jstate))
    images = np.random.default_rng(3).integers(
        0, 256, (2, *cfg.model.insize, 3), dtype=np.uint8)
    want = np.asarray(jst.make_forward(jcfg, graphdef)(jstate, images))
    got = st.make_forward(state)(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()

    # and back: a fine-tune start takes the snapshot, EMA seeded from it
    fresh = st.create_train_state(cfg, seed=7, device="cpu")
    load_npz_into_train_state(cfg, path, fresh)
    assert fresh.step == 0
    for n, p in fresh.model.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(),
            state.ema[n].numpy().astype(np.float16).astype(np.float32))
        assert torch.equal(fresh.ema[n], p.detach())
        assert not fresh.trace[n].any()


def test_device_cache_order_matches_jax():
    cfg = jax_get_config("tiny_test")
    ds = SyntheticPoseDataset(cfg, size=7, seed=2)
    ours = DeviceCache(ds, device="cpu")
    theirs = JaxDeviceCache(ds, image_uint8=True)
    assert ours.size == theirs.size == 7
    assert ours.nbytes() == theirs.nbytes()
    for gen, n in (("epoch_shuffled_batches", 2), ("infinite_batches", 5)):
        a = getattr(ours, gen)(3, seed=4)
        b = getattr(theirs, gen)(3, seed=4)
        for _ in range(n):
            x, y = next(a), next(b)
            for k in BATCH_KEYS:
                np.testing.assert_array_equal(x[k].numpy(),
                                              np.asarray(y[k]), err_msg=k)
    assert next(ours.epoch_shuffled_batches(3, seed=4), None) is not None
    # smaller than a batch: sampled with replacement, in the same order
    a, b = ours.infinite_batches(9, seed=1), theirs.infinite_batches(9, seed=1)
    for _ in range(2):
        np.testing.assert_array_equal(next(a)["image"].numpy(),
                                      np.asarray(next(b)["image"]))


# ---- the CLI ------------------------------------------------------------------

def test_train_cli_runs_on_cpu(tmp_path, capsys):
    from ppn_tpu_torch.apps import train

    train.main(["--device", "cpu", "--config", "tiny_test", "--overfit", "4",
                "--steps", "3", "--ckpt-dir", str(tmp_path),
                "--set", "train.log_every=1"])
    out = capsys.readouterr().out
    assert "step=3" in out and "final:" in out and "eval:" in out
    assert os.listdir(tmp_path) == ["ckpt_00000003.pt"]


@pytest.mark.parametrize("flags", [
    ["--data", "mpii"], ["--data", "coco"], ["--ini", "x.ini"],
    ["--pretrained", "r18.pth"], ["--steps-per-call", "4"],
    ["--set", "train.mesh_shape=(2,)"]])
def test_train_cli_refuses_unported_options(flags, tmp_path, capsys):
    """Every option the JAX CLI has is ported now; each case runs it.
    ``--data mpii|coco`` is ported: one step on a two-image file tree
    writes its checkpoint.
    ``--steps-per-call 4`` is ported: over the device cache, 5 steps are
    one K-step block (logged at step 4, not before) and one step of the
    per-step tail.
    ``--ini`` is ported: the INI's step count reaches the trainer.
    ``--pretrained`` is ported: the state before the first step holds the
    file's backbone. A mesh over more ranks than the world has (one
    process) is refused, never shrunk to fit."""
    from ppn_tpu_torch.apps import train

    argv = ["--device", "cpu", "--config", "tiny_test", "--ckpt-dir",
            str(tmp_path)]
    if flags[0] == "--data":
        from ppn_tpu_torch.configs import get_config
        from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
        from ppn_tpu_torch.testing import write_coco_set, write_mpii_set

        cfg = get_config("tiny_test")
        src = SyntheticPoseDataset(cfg, size=2, seed=0, cache=True)
        root = str(tmp_path / "data")
        if flags[1] == "mpii":
            write_mpii_set(cfg, root, {"train": (src, 2, 0)})
        else:
            write_coco_set(root, src, 2)
        train.main(argv + flags + ["--data-root", root, "--steps", "1",
                                   "--batch-size", "2"])
        assert sorted(os.listdir(tmp_path)) == ["ckpt_00000001.pt", "data"]
        return
    if flags[0] == "--ini":
        ini = tmp_path / flags[1]
        ini.write_text("[training]\nnum_steps = 1\n")
        train.main(argv + ["--ini", str(ini), "--overfit", "2"])
        assert sorted(os.listdir(tmp_path)) == ["ckpt_00000001.pt", "x.ini"]
        return
    if flags[0] == "--pretrained":
        from ppn_tpu_torch.nn.resnet import resnet18
        from ppn_tpu_torch.utils.torch_import import torchvision_state_dict

        torch.manual_seed(3)
        sd = torchvision_state_dict(resnet18())
        torch.save(sd, tmp_path / flags[1])
        train.main(argv + ["--pretrained", str(tmp_path / flags[1]),
                           "--overfit", "2", "--steps", "0"])
        model = torch.load(tmp_path / "ckpt_00000000.pt",
                           weights_only=True)["model"]
        assert torch.equal(model["backbone.stem.conv.weight"],
                           sd["conv1.weight"])
        assert torch.equal(model["backbone.blocks.7.conv2.bn.running_var"],
                           sd["layer4.1.bn2.running_var"])
        return
    if flags[0] == "--set":
        with pytest.raises(ValueError, match="does not cover the world of 1"):
            train.main(argv + flags)
        return
    import re

    train.main(argv + flags + ["--overfit", "2", "--steps", "5",
                               "--set", "train.log_every=1"])
    out = capsys.readouterr().out
    assert "device cache: 2 samples" in out
    logged = re.findall(r"\] step=(\d+) ", out)
    assert logged == ["4", "5"], logged
    assert os.listdir(tmp_path) == ["ckpt_00000005.pt"]
