"""The HRNet-W32 trunk (``ppn_tpu_torch/nn/hrnet.py``, ``backbone=
"hrnet_w32"``, the named ``mpii_hrw32_384``) against the plain reference
``tests/plain_hrnet.py`` on the CPU: published widths at tiny_test's 64²
input (2×2 grid) and B=2, f32, on seeded weights with BatchNorm scales,
biases and running statistics away from their init.

Tolerances, each of the largest value of what is compared:
  * eval mode, the trunk's map and the model's: 1e-5. Both sides run the
    same operations in the same order (the conv, ``SAME``'s explicit pad,
    BatchNorm as ``(x − mean)·mul + bias``, the sums in branch order), and
    measured bitwise; the margin is for a conv algorithm that sums in
    another order.
  * training mode, the maps: 1e-3. The port's BatchNorm takes the fast
    variance E[x²] − E[x]² in f32, the reference the two-pass one; at 64²
    the stride-32 layers' statistics are over 8 values a channel, where the
    two part by a few parts in 1e4 (measured 1.1e-4 on the model's map and
    2.0e-4 on the trunk's). The running statistics: 2e-4 (measured 2.5e-5).
  * the gradients of the PPN loss. The port's fast variance parts from
    the two-pass one by a few parts in 1e4 on 8-value channels, and the
    backward of 326 BatchNorm layers at a random init magnifies that: the
    gradients as a whole part by 5.8e-3 of their norm (measured), the
    median leaf by 5.6e-3 of its largest value. So the gradients are held
    twice: with the port's own BatchNorm, the whole gradient within 2e-2
    of its norm; and with the port's BatchNorm taking the two-pass
    variance in its place (``two_pass_bn``), which leaves the trunk's
    every other operation as it is, leaf by leaf within 1e-4 of the leaf's
    largest value (measured 1.3e-5, median 1.9e-6).
  * one K=2 call of ``make_multi_train_step`` (augmentation on, lr 0.01
    from the first step), with ``two_pass_bn``: each parameter's change
    over the call and each momentum trace, as a gap of the leaf's largest
    value, 1e-4 on the median leaf (measured 7.0e-6 and 5.2e-6) and 1e-2
    on the worst (measured 1.5e-3 and 3.0e-3: after the first step the
    parameters part by rounding, and a ReLU decision near 0 that flips in
    the second moves the BatchNorm bias gradient of its layer); the
    running statistics 2e-4 (7.9e-6), the mean loss 1e-5 relative
    (1.4e-7).
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_hrnet as plain
from ppn_tpu.configs import base as jax_configs
from ppn_tpu_torch import configs
from ppn_tpu_torch.data.device_cache import DeviceCache
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.nn import hrnet
from ppn_tpu_torch.nn.model import PoseProposalNet, num_params
from ppn_tpu_torch.ops import cuda_bn
from ppn_tpu_torch.ops import encode as enc
from ppn_tpu_torch.ops.augment import augment_batch
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.train.loss import ppn_loss
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVAL_TOL = 1e-5
TRAIN_TOL = 1e-3
STATS_TOL = 2e-4
GRAD_TOL = 1e-4
GRAD_NORM_TOL = 2e-2
STEP_MEDIAN_TOL = 1e-4
STEP_WORST_TOL = 1e-2
LOSS_TOL = 1e-5


def _cfg(**train):
    """tiny_test (64², 2×2 grid) on the HRNet-W32 trunk, f32, B=2."""
    cfg = configs.get_config("tiny_test")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone="hrnet_w32"),
        train=dataclasses.replace(cfg.train, dtype="float32", batch_size=2,
                                  **train))


def _weights(cfg, seed=0):
    """Every parameter and statistic of the plain reference's names: convs
    at LeCun's scale, BatchNorm scales near 1, biases, means and variances
    drawn away from their init."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for n, (s, kind) in plain.param_shapes(cfg.model.num_channels).items():
        r = torch.randn(s, generator=g)
        if kind == "conv":
            out[n] = r * (s[1] * s[2] * s[3]) ** -0.5
        elif kind == "bn_weight":
            out[n] = 1 + 0.1 * r
        elif kind == "bn_var":
            out[n] = 1 + torch.rand(s, generator=g)
        else:
            out[n] = 0.1 * r
    return out


def _images(b=2, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, 64, 64, 3), dtype=np.uint8))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def two_pass_bn(monkeypatch):
    """The port's CPU training-mode BatchNorm with the two-pass variance in
    place of E[x²] − E[x]², the reference's; everything else as it is."""
    def two_pass(x, weight, bias, running_mean, running_var, eps, momentum,
                 dtype, act=None, group=None):
        xf = x.to(dtype).float()
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
        mul = torch.rsqrt(var + eps) * weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return cuda_bn.activate(y + bias[:, None, None], act)

    monkeypatch.setattr(cuda_bn, "batch_norm_train_plain", two_pass)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    w = _weights(cfg)
    model = PoseProposalNet(cfg.model, dtype=torch.float32)
    model.load_state_dict(w)
    return cfg, w, model


@pytest.mark.parametrize("train", [False, True])
def test_trunk_and_model_match_plain(setup, train):
    cfg, w, model = setup
    model = PoseProposalNet(cfg.model, dtype=torch.float32)
    model.load_state_dict(w)
    model.train(train)
    got = {}
    hook = model.backbone.register_forward_hook(
        lambda m, i, o: got.__setitem__("trunk", o))
    stats = {k: w[k].clone() for k in plain.buffer_names(
        cfg.model.num_channels)}
    img = _images()
    with torch.no_grad():
        fm = model(img)
        want = plain.forward(w, img, train, stats)
        trunk = plain.trunk(w, img, train)
    hook.remove()
    assert fm.shape == (2, 2, 2, cfg.model.num_channels)
    assert got["trunk"].shape == (2, 2048, 2, 2)
    tol = TRAIN_TOL if train else EVAL_TOL
    assert _rel(got["trunk"], trunk) <= tol
    assert _rel(fm, want) <= tol
    sd = model.state_dict()
    for k, v in stats.items():
        if train:
            assert _rel(sd[k], v) <= STATS_TOL, k
        else:
            assert torch.equal(sd[k], w[k]), k


@pytest.mark.parametrize("variance", ["fast", "two_pass"])
def test_loss_gradients_match_plain(setup, variance, request):
    """The PPN loss's gradients through the head and the trunk, training
    mode, both sides' maps scored by the port's loss on one encoding; with
    the port's BatchNorm as it is, and with ``two_pass_bn``."""
    if variance == "two_pass":
        request.getfixturevalue("two_pass_bn")
    cfg, w, _ = setup
    model = PoseProposalNet(cfg.model, dtype=torch.float32).train()
    model.load_state_dict(w)
    ds = SyntheticPoseDataset(cfg, size=2, seed=4)
    rows = [ds[i] for i in range(2)]
    batch = {k: torch.from_numpy(np.stack([r[k] for r in rows]))
             for k in ("image", "keypoints", "visible", "bboxes", "valid")}
    t = enc.encode_batch(cfg.model, batch["keypoints"], batch["visible"],
                         batch["bboxes"], batch["valid"])
    names, params = zip(*model.named_parameters())
    got = torch.autograd.grad(
        ppn_loss(cfg.model, model(batch["image"]), t)[1]["loss_total"],
        params)
    leaves = {n: w[n].clone().requires_grad_(n in names) for n in w}
    want = torch.autograd.grad(
        ppn_loss(cfg.model, plain.forward(leaves, batch["image"], True),
                 t)[1]["loss_total"], [leaves[n] for n in names])
    assert len(names) == len(want) == 3 * 326 + 2
    if variance == "fast":
        a, b = (torch.cat([g.flatten() for g in gs]) for gs in (got, want))
        assert float((a - b).norm() / b.norm()) <= GRAD_NORM_TOL
    else:
        worst = max((_rel(a, b), n) for n, a, b in zip(names, got, want))
        assert worst[0] <= GRAD_TOL, worst


def test_multi_train_step_matches_plain(setup, two_pass_bn):
    """One K=2 call of ``make_multi_train_step`` over a ``DeviceCache``,
    augmentation on, against the plain reference stepping the same
    gathered batches: the same augmentation draws (a generator seeded as
    the state's), the port's encoding and loss, the reference's forward
    and gradients, and SGD with momentum and masked weight decay written
    out at the port's schedule; the port's BatchNorm with the two-pass
    variance (the module docstring says why)."""
    _, w, _ = setup
    cfg = _cfg(lr_schedule="constant", warmup_steps=0, learning_rate=0.01)
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=4, seed=0),
                        device="cpu")
    idx = np.array([[0, 3], [2, 1]], dtype=np.int32)
    state = st.create_train_state(cfg, seed=5, device="cpu")
    state.model.load_state_dict(w)
    gen = torch.Generator().manual_seed(5)
    got = st.make_multi_train_step(cfg, augment=True, steps_per_call=2)(
        state, cache, idx)

    names = [n for n, _ in state.model.named_parameters()]
    params = {n: w[n].clone() for n in names}
    stats = {k: w[k].clone() for k in plain.buffer_names(
        cfg.model.num_channels)}
    trace = {n: torch.zeros_like(p) for n, p in params.items()}
    lr = st.make_lr_schedule(cfg)
    losses = []
    for count, i in enumerate(idx):
        b = augment_batch(cfg.model, cfg.data, gen, cache.batch(i),
                          device="cpu")
        t = enc.encode_batch(cfg.model, b["keypoints"], b["visible"],
                             b["bboxes"], b["valid"])
        leaves = {n: p.requires_grad_(True) for n, p in params.items()}
        loss = ppn_loss(cfg.model, plain.forward({**leaves, **stats},
                                                 b["image"], True, stats),
                        t)[1]["loss_total"]
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n].requires_grad_(False)
                if p.ndim > 1:
                    g = g + cfg.train.weight_decay * p
                trace[n] = cfg.train.momentum * trace[n] + g
                params[n] = p - lr(count) * trace[n]

    assert state.step == 2
    assert abs(float(got["loss_total"]) - np.mean(losses)) \
        <= LOSS_TOL * abs(np.mean(losses))
    sd = state.model.state_dict()
    change = [_rel(sd[n] - w[n], params[n] - w[n]) for n in names]
    traces = [_rel(state.trace[n], trace[n]) for n in names]
    for gaps in (change, traces):
        assert np.median(gaps) <= STEP_MEDIAN_TOL
        assert max(gaps) <= STEP_WORST_TOL
    for k, v in stats.items():
        assert _rel(sd[k], v) <= STATS_TOL, k


def test_fuses_counted_and_parameters(setup):
    """8 exchange units a forward (stages of 1, 4 and 3 modules); the
    trunk's trainable values (conv weights, BatchNorm scales and biases)
    are the reference's, 39,179,840 at published widths."""
    cfg, w, model = setup
    before = hrnet.FUSES
    with torch.no_grad():
        model.eval()(_images(1))
    assert hrnet.FUSES - before == 8
    want = sum(int(np.prod(s)) for n, (s, kind) in plain.param_shapes(
        cfg.model.num_channels).items()
        if n.startswith("backbone.") and kind not in ("bn_mean", "bn_var"))
    assert num_params(model.backbone) == want == 39_179_840
    assert set(model.state_dict()) == set(w)


def test_named_config_resolves_for_the_port_only():
    cfg = configs.get_config("mpii_hrw32_384")
    assert cfg.name == "mpii_hrw32_384"
    assert cfg.model == configs.PPNConfig(backbone="hrnet_w32")
    assert cfg.train == configs.TrainConfig()
    assert cfg.data == configs.DataConfig()
    assert configs.resolve_config("mpii_hrw32_384") == cfg
    assert "mpii_hrw32_384" not in configs._REGISTRY
    assert set(configs._REGISTRY) == set(jax_configs._REGISTRY)
    with pytest.raises(KeyError, match="mpii_hrw32_384"):
        configs.get_config("nope")


def test_pretrained_refuses_hrnet(tmp_path):
    with pytest.raises(ValueError, match="not HRNet"):
        st.create_train_state(_cfg(), device="cpu",
                              pretrained=str(tmp_path / "r50.pth"))


@pytest.mark.parametrize("tool", ["torch_train_split", "torch_bwd_split",
                                  "torch_fwd_split"])
def test_stage_profilers_refuse_hrnet(tool):
    import importlib

    mod = importlib.import_module(f"tools.{tool}")
    with pytest.raises(ValueError, match="'hrnet_w32'"):
        mod.main(["--config", "mpii_hrw32_384", "--device", "cpu"])


def test_predict_and_train_cli_run_hrnet(tmp_path):
    """The normal entry points with no HRNet branch: ``Predictor.predict``
    on the seeded model, and the train CLI (``--backbone hrnet_w32``) for
    two steps."""
    from ppn_tpu_torch.apps import train as train_app
    from ppn_tpu_torch.inference import Predictor

    cfg = _cfg()
    model = PoseProposalNet(cfg.model, dtype=torch.float32)
    ppl = Predictor(cfg, model, device="cpu").predict(_images().numpy())
    assert ppl.valid.shape == (2, cfg.model.max_instances)
    before = hrnet.FUSES
    train_app.main(["--device", "cpu", "--config", "tiny_test", "--backbone",
                    "hrnet_w32", "--overfit", "2", "--steps", "2",
                    "--batch-size", "2", "--ckpt-dir",
                    str(tmp_path / "ckpt"), "--no-resume"])
    assert hrnet.FUSES - before >= 2 * 8
