"""The port's stage profilers (tools/torch_{train,bwd,fwd}_split.py) against
the JAX package on the CPU, at tiny_test's 64² and B ≤ 4.

What is held:
  * the port's ``s2d_weights`` bitwise the JAX tool's
    (tools/fwd_split.s2d_weights) on seeded weights, and the s2d stem
    against the 7×7 stem in f32 within tests/test_torch_model.py's
    ``F32_TOL`` (2e-5) of the largest value: the rewrite is exact math,
    the two convs sum in other orders;
  * each bwd_split stage's output and VJP (cotangent the output itself,
    parameter gradients, and the input's gradient but at the stem), f32 in
    training mode, against Flax's ``jax.vjp`` of the same stage on the
    same input, weights carried over by ``utils/params_io``, within
    ``F32_TOL`` of each tensor's largest value: ResNet-18, and ResNet-34's
    s1–s4, whose 3/4/6/3 split the JAX tool's ``len(blocks) // 4`` gets
    wrong;
  * the stages composed bitwise ``backbone(x)`` for all three backbones,
    and fwd_split's ``ingest`` ∘ ``blocks`` ∘ ``head`` bitwise
    ``model(img)``: the same calls in the same order;
  * train_split's ``full_body`` row, ``train_step(augment=True)`` on a
    ``copy_state`` copy: the copy steps bitwise as the state it came from
    and leaves that state as it was; ``fwdbwd_only`` bitwise
    ``steps.loss_and_grads``;
  * bwd_split's ``--batch-norm``: every BatchNorm layer timed once, on the
    input the stages' forward gave it;
  * each tool's record from ``main(["--device", "cpu", ...])`` with the
    JAX tool's keys (listed from its source) plus ``device_busy_ms`` and
    ``host_bound``, which are None on the CPU: it records no device work.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.pipeline import collate
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.ops.encode import encode_batch
from ppn_tpu_torch.train.steps import (BATCH_KEYS, create_train_state,
                                       grad_norm, loss_and_grads, train_step)
from ppn_tpu_torch.utils.params_io import (_leaf_specs,
                                           state_dict_from_jax_leaves)
from tools import fwd_split as jax_fwd_split
from tools import torch_bwd_split, torch_fwd_split, torch_train_split

from test_torch_model import F32_TOL, _jax_template, _numpy_leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(backbone="resnet18"):
    """tiny_test of both packages (64², 2×2 grid) with ``backbone``."""
    return [dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=backbone))
        for cfg in (jax_get_config("tiny_test"), get_config("tiny_test"))]


def _port_model(cfg, leaves, dtype):
    model = PoseProposalNet(cfg.model, dtype=dtype)
    model.load_state_dict(state_dict_from_jax_leaves(cfg, leaves, model))
    return model


def _image(cfg, B, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (B, *cfg.model.insize, 3), np.float32))


def _within(got, want, tol=F32_TOL):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def test_s2d_weights_match_the_jax_tool():
    w7 = np.random.default_rng(0).normal(0.0, 0.1, (7, 7, 3, 64)).astype(
        np.float32)
    got = torch_fwd_split.s2d_weights(w7)
    want = jax_fwd_split.s2d_weights(w7)
    assert got.shape == want.shape == (4, 4, 12, 64)
    assert np.array_equal(got, want)


def test_s2d_stem_matches_the_7x7_stem_in_f32():
    jcfg, cfg = _configs()
    _, flat, _ = _jax_template(jcfg.model)
    model = _port_model(cfg, _numpy_leaves(flat, seed=1),
                        torch.float32).eval()
    stems = torch_fwd_split.stem_variants(model)
    img = _image(cfg, 2)
    with torch.no_grad():
        a, b = stems["stem7"](img), stems["s2d"](img)
    assert a.shape == b.shape == (2, 64, 16, 16)
    _within(b.numpy(), a.numpy())


def _jax_stage(m, name, x, ends):
    """The JAX model's stage ``name`` split at the cumulative stage sizes
    ``ends``, as the port's tool splits it."""
    if name == "stem":
        y = nnx.relu(m.backbone.stem(x))
        return nnx.max_pool(y, window_shape=(3, 3), strides=(2, 2),
                            padding="SAME")
    if name == "head":
        return m.head(x)
    i = int(name[1:]) - 1
    for blk in m.backbone.blocks[([0] + ends)[i]:ends[i]]:
        x = blk(x)
    return x


@pytest.mark.parametrize("backbone, sizes", [("resnet18", [2, 2, 2, 2]),
                                             ("resnet34", [3, 4, 6, 3])])
def test_bwd_stages_match_flax_vjp(backbone, sizes):
    """The port's stages in f32 against Flax's in f64 (JAX's x64 mode, the
    same f32 weights): Flax's own f32 run is 3.6e-5 of the largest value
    off its f64 run on the stem's weight gradient, where the cotangent
    ``y`` cancels through the training-mode BatchNorm backward, and the
    port's f32 run 4.3e-6, so the exact reference is the one that can
    hold the port to ``F32_TOL``. ResNet-34 holds s1–s4, the stages its
    3/4/6/3 split makes: its stem and head are ResNet-18's modules, held
    in that case."""
    jcfg, cfg = _configs(backbone)
    with jax.enable_x64(True):
        graphdef, flat, treedef = _jax_template(jcfg.model, jnp.float64)
    leaves = _numpy_leaves(flat, seed=1)
    model = _port_model(cfg, leaves, torch.float32).train()
    assert [len(s) for s in model.backbone.stages()] == sizes
    inputs = torch_bwd_split.stage_inputs(model, _image(cfg, 2))
    names = torch_bwd_split.stage_names(model.backbone)
    assert names == ["stem", "s1", "s2", "s3", "s4", "head"]
    specs = {name: (path, is_kernel)
             for path, name, is_kernel in _leaf_specs(model)
             if path[0] == "params"}
    torch_name = {id(p): n for n, p in model.named_parameters()}
    ends = list(np.cumsum(sizes))

    with jax.enable_x64(True):
        tree = jax.tree.unflatten(treedef, [jnp.asarray(a, jnp.float64)
                                            for a in leaves])
        params, rest = tree["params"], tree["rest"]

        def merged(pp):
            # re-box the statistics at this trace level: training-mode BN
            # updates them, which Flax allows only at the trace they live in
            m = nnx.merge(graphdef, pp, jax.tree.map(lambda v: v, rest))
            m.train()
            return m

        held = names if backbone == "resnet18" else names[1:-1]
        for name in held:
            x = inputs[name]
            y = torch_bwd_split.stage_fn(model, name)(x)
            grads = torch_bwd_split.fwdbwd_fn(model, name, x)()
            stage_params = list(
                torch_bwd_split.stage_modules(model, name).parameters())
            assert len(grads) == len(stage_params) + (name != "stem")

            @jax.jit
            def reference(pp, xx, name=name):
                """The stage's output and VJP (cotangent the output), over
                the parameters and, but at the stem, the input."""
                if name == "stem":
                    y, vjp = jax.vjp(
                        lambda q: _jax_stage(merged(q), name, xx, ends), pp)
                    return y, vjp(y)[0], None
                y, vjp = jax.vjp(
                    lambda q, v: _jax_stage(merged(q), name, v, ends), pp, xx)
                return (y, *vjp(y))

            want_y, dp, dx = reference(params, jnp.asarray(
                x.permute(0, 2, 3, 1).numpy(), jnp.float64))
            if name != "stem":
                _within(grads[-1].permute(0, 2, 3, 1).numpy(),
                        np.asarray(dx))
            _within(y.detach().permute(0, 2, 3, 1).numpy(),
                    np.asarray(want_y))
            want = dict(zip(sorted(specs, key=lambda n: specs[n][0]),
                            jax.tree.leaves(dp)))
            for p, g in zip(stage_params, grads):
                n = torch_name[id(p)]
                w = np.asarray(want[n])
                if specs[n][1]:
                    w = w.transpose(3, 2, 0, 1)         # HWIO → OIHW
                _within(g.numpy(), w)


@pytest.mark.parametrize("backbone, widths", [
    ("resnet18", [64, 64, 128, 256, 512]),
    ("resnet34", [64, 64, 128, 256, 512]),
    ("resnet50", [64, 256, 512, 1024, 2048])])
def test_bwd_stages_compose_to_the_backbone(backbone, widths):
    """In training mode and the config's bf16: each stage's input is the
    previous stage's output, the head's input is ``backbone(x)`` bitwise,
    and each stage's width follows the backbone's own structure."""
    _, cfg = _configs(backbone)
    torch.manual_seed(0)
    model = PoseProposalNet(cfg.model).train()
    x = _image(cfg, 2).to(torch.bfloat16).permute(0, 3, 1, 2)
    inputs = torch_bwd_split.stage_inputs(model, _image(cfg, 2))
    with torch.no_grad():
        want = model.backbone(x)
        assert torch.equal(inputs["stem"], x)
        assert [inputs[f"s{i}"].shape[1] for i in range(1, 5)] + [
            inputs["head"].shape[1]] == widths
        assert torch.equal(inputs["head"], want)
        assert inputs["head"].is_contiguous(
            memory_format=torch.channels_last)


def test_fwd_split_composes_to_the_model():
    _, cfg = _configs()
    torch.manual_seed(0)
    model = PoseProposalNet(cfg.model).eval()
    img = _image(cfg, 2)
    with torch.no_grad():
        got = torch_fwd_split.head(model, torch_fwd_split.blocks(
            model, torch_fwd_split.ingest(model, img)))
        want = model(img)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def tiny_step():
    cfg = get_config("tiny_test")
    ds = SyntheticPoseDataset(cfg, size=2, seed=0, cache=True)
    host = collate([ds[i] for i in range(2)])
    batch = {k: torch.from_numpy(host[k]) for k in BATCH_KEYS}
    return cfg, create_train_state(cfg, device="cpu"), batch


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def test_full_body_is_train_step(tiny_step):
    cfg, _, batch = tiny_step
    state = create_train_state(cfg, device="cpu")
    before = _params(state)
    b = torch_train_split.copy_state(state)
    got = train_step(cfg, b, batch, augment=True)
    # the copy shared nothing with the state it came from
    assert all(torch.equal(p, before[n]) for n, p in _params(state).items())
    want = train_step(cfg, state, batch, augment=True)
    assert set(got) == set(want) and "grad_norm" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    after = _params(state)
    for n, p in _params(b).items():
        assert torch.equal(p, after[n]), n
        assert torch.equal(b.trace[n], state.trace[n]), n
    assert (b.ema is None) == (state.ema is None)
    for n, t in (state.ema or {}).items():
        assert torch.equal(b.ema[n], t), n
    assert torch.equal(b.generator.get_state(), state.generator.get_state())
    assert b.step == state.step


def test_fwdbwd_only_is_loss_and_grads(tiny_step):
    cfg, state, batch = tiny_step
    want_terms, want = loss_and_grads(
        cfg, torch_train_split.copy_state(state), batch)
    targets = encode_batch(cfg.model, batch["keypoints"], batch["visible"],
                           batch["bboxes"], batch["valid"])
    terms, grads, norm = torch_train_split.fwdbwd_only(
        cfg, torch_train_split.copy_state(state).model, batch["image"],
        targets)
    assert all(torch.equal(terms[k], want_terms[k]) for k in want_terms)
    assert list(grads) == list(want)
    assert all(torch.equal(grads[n], want[n]) for n in want)
    assert torch.equal(norm, grad_norm(want))


class _Event:
    def __init__(self, name, cuda, corr, ns=0):
        self._v = (name, cuda, corr, ns)

    def start_ns(self):
        return self._v[2]                  # launches in correlation order

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def _window(events):
    """A finished profiler window as ``window_busy_ms`` reads it."""
    import types

    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_window_busy_counts_unrecorded_launches():
    """Busy time per call by category, and the share of kernel launches
    that have a device record: the profiler on the card has left some
    without one, and ``host_bound`` then answers None."""
    from ppn_tpu_torch.utils.profiling import host_bound, window_busy_ms

    events = [_Event("aten::sub", False, 0), _Event("cudaLaunchKernel", False,
                                                     1),
              _Event("cudaLaunchKernel", False, 2),
              _Event("cudaLaunchKernelExC", False, 3),
              _Event("cudaMemsetAsync", False, 4),
              _Event("elementwise_kernel", True, 1, 2_000_000),
              _Event("sm90_xmma_conv", True, 3, 4_000_000),
              _Event("Memset (Device)", True, 4, 1_000_000)]
    busy, share = window_busy_ms(_window(events), 2,
                                 lambda n: n.split("_")[0])
    assert busy == {"elementwise": 1.0, "sm90": 2.0, "Memset (Device)": 0.5,
                    "total": 3.5}
    assert share == 2 / 3                # launch 2 has no device record
    assert host_bound(4.0, {**busy, "recorded": share}) is None
    assert host_bound(4.0, {**busy, "recorded": 1.0}) is True
    assert host_bound(3.8, {**busy, "recorded": 1.0}) is False
    busy, share = window_busy_ms(_window(events[:1]), 3)
    assert busy == {"total": 0.0} and share == 1.0
    # one marker launch first: it and its record are left out
    marker = [_Event("cudaLaunchKernel", False, -1),
              _Event("vectorized_elementwise_kernel", True, -1, 9_000_000)]
    assert window_busy_ms(_window(marker + events), 2,
                          lambda n: n.split("_")[0], skip=1) == (
        {"elementwise": 1.0, "sm90": 2.0, "Memset (Device)": 0.5,
         "total": 3.5}, 2 / 3)
    assert window_busy_ms(_window(marker[:1] + events[5:]), 2, skip=1) == (
        {"kernels": 3.5, "total": 3.5}, 1.0)


# the record keys of the JAX tools, from their source
TRAIN_KEYS = {"config", "batch", "backend", "full_step_ms",
              "full_step_images_per_sec", "no_augment_step_ms", "device_ms",
              "device_images_per_sec",
              "residual_ms_optimizer_ema_bookkeeping", "note"}
TRAIN_ROWS = {"augment_only", "encode_only", "fwd_only", "fwdbwd_only",
              "opt_ema_only", "full_body"}
BWD_STAGE_KEYS = {"fwdbwd_ms", "ms_per_img_fwdbwd", "fwd_ms", "bwd_ms",
                  "bwd_over_fwd"}
FWD_KEYS = {"batch", "s2d_max_abs_diff"} | {
    f"{n}_ms" for n in ("full", "ingest", "blocks", "head", "norm_only",
                        "conv7_only", "stem7", "s2d")}
PORT_KEYS = {"device_busy_ms", "host_bound"}


def test_train_split_record_has_the_jax_keys(capsys):
    # the costly fwdbwd and full_body rows are held above, call by call
    rec = torch_train_split.main([
        "--device", "cpu", "--config", "tiny_test", "--batch", "1",
        "--iters", "1", "--stages", "full,augment,encode,fwd,opt"])
    assert set(rec) == TRAIN_KEYS | PORT_KEYS
    assert set(rec["device_ms"]) == TRAIN_ROWS
    timed = {"full", "augment_only", "encode_only", "fwd_only",
             "opt_ema_only"}
    assert {k for k, v in rec["device_ms"].items() if v is not None} | {
        "full"} == timed
    assert rec["full_step_ms"] > 0 and rec["no_augment_step_ms"] is None
    assert rec["backend"] == "cpu"
    assert set(rec["device_busy_ms"]) == set(rec["host_bound"]) == timed
    assert not any(rec["device_busy_ms"].values())
    assert not any(rec["host_bound"].values())
    printed = capsys.readouterr().out
    assert "[train_split] full_step " in printed
    assert printed.rstrip().endswith("}")


def test_bwd_split_record_has_the_jax_keys(capsys):
    rec = torch_bwd_split.main(["--device", "cpu", "--config", "tiny_test",
                                "--batches", "1", "--iters", "1"])
    assert set(rec) == {"config", "iters", "batches"}
    (row,) = rec["batches"]
    assert set(row) == {"batch", "stages", "sum_fwd_ms", "sum_fwdbwd_ms"}
    assert list(row["stages"]) == ["stem", "s1", "s2", "s3", "s4", "head"]
    for st in row["stages"].values():
        assert set(st) == BWD_STAGE_KEYS | PORT_KEYS
        assert st["device_busy_ms"] == {"fwd": None, "fwdbwd": None}
        assert st["host_bound"] == {"fwd": None, "fwdbwd": None}
    assert "B=1 s4: fwd " in capsys.readouterr().out

    rec = torch_bwd_split.main(["--device", "cpu", "--config", "tiny_test",
                                "--batches", "1", "--iters", "1",
                                "--stages", "head", "--skip-fwd",
                                "--batch-norm"])
    (row,) = rec["batches"]
    assert set(row) == {"batch", "stages", "sum_fwdbwd_ms", "batch_norm"}
    assert set(row["stages"]["head"]) == {"fwdbwd_ms", "ms_per_img_fwdbwd"
                                          } | PORT_KEYS
    # the port's --batch-norm entry: every BatchNorm layer alone
    assert set(row["batch_norm"]) == {"layers", "fwd_ms", "fwdbwd_ms",
                                      "device_busy_ms", "host_bound"}
    assert row["batch_norm"]["layers"] == 21
    assert row["batch_norm"]["device_busy_ms"] == {"fwd": None,
                                                   "fwdbwd": None}
    assert "B=1 batch_norm (21 layers): fwd " in capsys.readouterr().out


def test_bwd_split_times_each_batch_norm_layer_alone():
    from ppn_tpu_torch.nn.resnet import BatchNorm

    _, cfg = _configs()
    torch.manual_seed(0)
    model = PoseProposalNet(cfg.model).train()
    calls = torch_bwd_split.batch_norm_calls(model, _image(cfg, 2))
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(calls) == len(layers) == 21
    assert {id(layer) for layer, _ in calls} == {id(m) for m in layers}
    # the stem's BatchNorm takes the stem conv's output
    x = _image(cfg, 2).to(model.dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(calls[0][1], model.backbone.stem.conv(x))
    fwd, fwdbwd = torch_bwd_split.batch_norm_fns(calls)
    for (layer, x), y, grads in zip(calls, fwd(), fwdbwd()):
        assert y.shape == x.shape
        assert [g.shape for g in grads] == [x.shape, layer.weight.shape,
                                            layer.bias.shape]


def test_bwd_split_refuses_fwd_only_with_skip_fwd():
    with pytest.raises(SystemExit):
        torch_bwd_split.main(["--device", "cpu", "--fwd-only", "--skip-fwd"])


def test_fwd_split_record_has_the_jax_keys(capsys):
    rec = torch_fwd_split.main(["--device", "cpu", "--config", "tiny_test",
                                "--batch", "1", "--iters", "1"])
    assert set(rec) == FWD_KEYS | PORT_KEYS
    names = {k[:-3] for k in FWD_KEYS if k.endswith("_ms")}
    assert set(rec["device_busy_ms"]) == set(rec["host_bound"]) == names
    assert np.isfinite(rec["s2d_max_abs_diff"])
    assert "s2d 4x4/s1 C=12:" in capsys.readouterr().out
