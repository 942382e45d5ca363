"""The plain reference equals the program's plain path at tiny_test on the
CPU: the model in float32 in eval and training mode, the post-process,
the augmentation draws, the warp (but for the program's bfloat16
roundings), the encoding, the loss, the schedule and the optimizer."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.reference import model as refmodel
from perfbench.reference import post as refpost
from perfbench.reference import train as reftrain
from perfbench.reference.geometry import Geometry
from perfbench.tests import tiny
from perfbench.yardstick import synthetic, weights


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def setup(request):
    from ppn_tpu_torch.configs import get_config

    cfg = tiny.config_file("tiny_test", request.param)
    pc = get_config("tiny_test")
    pc = dataclasses.replace(
        pc, model=dataclasses.replace(pc.model, backbone=request.param),
        train=dataclasses.replace(pc.train, dtype="float32"))
    w = weights.seeded(cfg["model"], 11, "cpu")
    gen = torch.Generator().manual_seed(3)
    for k in w:
        if k.endswith("running_mean"):
            w[k] = 0.1 * torch.randn(w[k].shape, generator=gen)
        if k.endswith("running_var"):
            w[k] = 1.0 + torch.rand(w[k].shape, generator=gen)
    data = synthetic.render_set(cfg["model"], cfg["data"]["max_persons"], 5,
                                4, workers=1)
    return cfg, pc, w, {k: torch.from_numpy(v) for k, v in data.items()}


def _program_model(pc, w):
    from ppn_tpu_torch.nn.model import PoseProposalNet

    model = PoseProposalNet(pc.model, dtype=torch.float32)
    model.load_state_dict(w)
    return model


@pytest.mark.parametrize("train", [False, True])
def test_model_equals_the_programs_in_float32(setup, train):
    cfg, pc, w, batch = setup
    model = _program_model(pc, w).train(train)
    with torch.no_grad():
        want = model(batch["image"])
        got = refmodel.forward(cfg["model"], w, batch["image"], train=train)
    # in training mode the last stage's BatchNorm takes each channel's
    # statistics over 16 values, where the program's E[x²] − E[x]² and the
    # reference's two-pass variance part by a few parts in 1e4
    tol = 1e-3 if train else 2e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_post_equals_the_programs_plain_version(setup):
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    cfg, pc, w, batch = setup
    g = Geometry(cfg["model"])
    gen = torch.Generator().manual_seed(9)
    fm = torch.randn((6, *g.outsize, g.num_channels), generator=gen)
    fm[..., :2 * g.num_classes] += 2.0
    want = postprocess_batch_plain(pc.model, fm)
    got = refpost.postprocess(g, fm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_augmentation_encoding_and_loss_equal_the_programs(setup):
    from ppn_tpu_torch.ops import augment, encode
    from ppn_tpu_torch.train.loss import ppn_loss

    cfg, pc, w, batch = setup
    g = Geometry(cfg["model"])
    g1, g2 = (torch.Generator().manual_seed(21) for _ in range(2))
    params = augment.sample_params(pc.model, pc.data, g1, batch["bboxes"],
                                   batch["valid"])
    mine = reftrain.sample_params(g, cfg["data"], g2, batch["bboxes"],
                                  batch["valid"])
    for a, b in zip(mine, (params.bwd, params.fwd, params.scale,
                           params.flip, params.color)):
        assert torch.equal(a, b)
    img = batch["image"].float() / 255.0
    torch.testing.assert_close(reftrain.warp(img, params.bwd),
                               augment.affine_warp_batch(img, params.bwd),
                               rtol=0, atol=2e-2)  # the program's bf16 taps
    theirs = augment.apply_augment(
        pc.model, dataclasses.replace(pc.data, augment_dtype="float32"),
        params, batch)
    g3 = torch.Generator().manual_seed(21)
    ours = reftrain.augment(g, cfg["data"], g3, batch)
    for k in ("keypoints", "visible", "bboxes", "valid"):
        assert torch.equal(ours[k], theirs[k]), k
    t_prog = encode.encode_batch(pc.model, theirs["keypoints"],
                                 theirs["visible"], theirs["bboxes"],
                                 theirs["valid"])
    t_ref = reftrain.encode(g, ours["keypoints"], ours["visible"],
                            ours["bboxes"], ours["valid"])
    for k in t_ref:
        assert torch.equal(t_ref[k], getattr(t_prog, k)), k
    fm = torch.randn((4, *g.outsize, g.num_channels),
                     generator=torch.Generator().manual_seed(2))
    _, want = ppn_loss(pc.model, fm, t_prog)
    got = reftrain.loss(g, fm, t_ref)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_schedule_and_optimizer_equal_the_programs(setup):
    from ppn_tpu_torch.train import steps

    cfg, pc, w, batch = setup
    for sched in ("cosine", "constant", "step"):
        t = dict(cfg["train"], lr_schedule=sched, num_steps=1000,
                 warmup_steps=10)
        p = dataclasses.replace(pc, train=dataclasses.replace(
            pc.train, lr_schedule=sched, num_steps=1000, warmup_steps=10))
        lr = steps.make_lr_schedule(p)
        for count in (0, 3, 10, 11, 599, 600, 851, 2000):
            assert reftrain.learning_rate(t, count) == lr(count), count
    state = steps.create_train_state(pc, seed=1, device="cpu")
    state.model.load_state_dict(w)
    ref = reftrain.Trainer(cfg, w, 1, "cpu")
    ref.count = state.step = 700
    gen = torch.Generator().manual_seed(5)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in state.model.named_parameters()}
    for _ in range(2):
        steps.sgd_update(pc, state, grads)
        ref._sgd(grads)
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(ref.params[n], p.detach(), rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(ref.trace[n], state.trace[n], rtol=1e-6,
                                   atol=1e-7)


def test_a_reference_step_follows_the_programs_step(setup):
    from ppn_tpu_torch.train import steps

    cfg, pc, w, batch = setup
    pc = dataclasses.replace(pc, data=dataclasses.replace(
        pc.data, augment_dtype="float32"))
    state = steps.create_train_state(pc, seed=13, device="cpu")
    state.model.load_state_dict(w)
    ref = reftrain.Trainer(cfg, w, 13, "cpu")
    for _ in range(2):
        want = steps.train_step(pc, state, batch, augment=True)
        got, _ = ref.step(batch)
        # the program's warp rounds its taps and pixels to bfloat16, and at
        # 64x64 the last stages' statistics are over a few values
        np.testing.assert_allclose(float(got["loss_total"]),
                                   float(want["loss_total"]), rtol=1e-2)
