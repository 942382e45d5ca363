"""Phases 20-23 and 26-30: the paths beside inference and training —
export, ``--pretrained``, profiling and debug, native JPEG decoding, the
benchmark suite, the parity leftovers, the rest of the model family, the
accuracy tools and the stage profilers."""

from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from chip.context import (CROWD_SNAPSHOT, FLOATS, OVERFIT_STEPS, ROOT,
                          SNAPSHOT, ULP_LIMIT, VIDEO_FRAMES, frame_vs_plain,
                          constant_lr, log, max_rel_state, metrics, overfit,
                          quiet_call, scratch_dir, train_cli, video_cli)
from chip.inference import FILE_VIDEO_FRAMES, sha256_of
from chip.kernels import (check_nan_window, check_post, check_warp,
                          post_time, warp_bound_ms, warp_matrices)
from chip.timing import event_times, graph_ms, host_us, time_ms, timed

# Phase 23: the protocol images enlarged 2.5× (384² → 960²) as MPII JPEGs
# (testing.write_mpii_set(..., "jpg", scale=2.5)), and the JAX package's
# PCKh on them on its CPU (train/steps.make_forward through
# eval/runner.evaluate_pckh, ppn_tpu/data/mpii.py at native_jpeg=True, det
# 0.02, nms 0.45, B=8) over its joints; where it was taken: PIL, its
# libjpeg-turbo, the files' sha256 and that of the 16 arrays
# native/loader.decode_resize gives at 384² (in file order)
NATIVE_SCALE, NATIVE_PIN = 2.5, (0.976190, 378)
NATIVE_SET_ORIGIN = {
    "pil": "12.1.0", "libjpeg_turbo": "3.1.3",
    "files": ("2ba771ad180d4089a08fb4621a584d97"
              "6e567f8dc0b256a017e2d3e122a30024"),
    "decoded": ("e5ea81679d252475a43856e208b6cdd4"
                "34be58f8ec08a71e725f926e54dc720e")}
POOL_JOBS = 128          # phase 23: images through the pool per timing
# phase 26: the suite's twelve configs, each at its reference defaults
BENCH_CONFIGS = ("1", "2", "3", "3b", "3c", "4", "4b", "5", "5p", "6", "7",
                 "7w")
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "batch",
                 "mfu_pct", "device_batch_ms", "host_loop_images_per_sec",
                 "flops_source", "card"}
# phase 27: the loader's images and worker processes, the steps taken
PARITY_IMAGES, PARITY_WORKERS, PARITY_STEPS = 64, 4, 10
# the JAX package's num_params of mpii_r18_384, which
# tests/test_torch_leftovers.py pins on the CPU
MPII_R18_384_PARAMS = 14_254_006
# phase 28: the family's forwards held card against CPU, (config, backbone)
FAMILY_FORWARDS = (("mpii_r50_384", None), ("mpii_r18_384", "resnet34"),
                   ("mpii_r18_224_fast", None))
BF16_TOL = 3e-2          # tests/test_torch_model.py's bf16 logit tolerance
FAMILY_F32_TOL = 1e-4    # f32 with TF32 off: cuDNN may choose FFT or
                         # Winograd algorithms, whose error exceeds a direct
                         # sum's; 5× the JAX-vs-port F32_TOL over ResNet-50's
                         # 53 convs, and phase 13's limit on a step's terms
FAMILY_TRAIN_IMAGES, FAMILY_STEPS = 32, 10
# the f32 ResNet-50 step, card against CPU, B=2 from a fresh init: the
# loss terms within phase 13's rel 1e-4; grad_norm within rel 1e-3. That
# gradient is poorly conditioned: moving every input pixel one f32 ulp
# moves grad_norm rel 3.9e-4 on the card and single gradient tensors by up
# to 16% of their largest value (the phase records both; PERF.md),
# so the step's gradients and updated state are recorded, not held. What is
# held instead: two Bottleneck blocks in training mode on seeded inputs,
# the CPU replaying the card's ReLU decisions (tests/test_torch_family.py's
# limits against Flax: output and gradients 2e-5, statistics 1e-5 of each
# tensor's largest value), and the update
# applied to the same gradients on both sides (1e-6 of each tensor's
# largest value: elementwise ops, a few ulps at most)
FAMILY_STEP_REL, FAMILY_GRAD_NORM_REL = 1e-4, 1e-3
BLOCK_TOL, BLOCK_STATS_TOL, UPDATE_TOL = 2e-5, 1e-5, 1e-6
# (cin, cout, stride, input side) of each Bottleneck: layer2's first block
# (the stride-2 projection, 256 -> 128·4) and its second (identity) at
# their sizes in mpii_r50_384
FAMILY_BLOCKS = ((256, 128, 2, 96), (512, 128, 1, 48))
# phase 29: the tools' sizes, and the JAX package's values on its CPU at
# exactly phase 29's arguments (tools/oracle_ceiling.py,
# tools/threshold_sweep.py, tools/crowding_study.py; "f32": the same runs
# with the config's train.dtype set to float32 in ppn_tpu.configs.get_config,
# which the port equals exactly on its CPU). Sweep points are "det/nms",
# crowding points "protocol@nms"; "exact" is each protocol's collision
# bound, lost-person fraction and oracle ceilings at nms 0.3/0.45/0.6.
TOOL_SWEEP_IMAGES, TOOL_CROWD_IMAGES = 64, 32
# phase 30: the stage profilers' iterations (each timed row is a slope over
# 1 + 9·iters calls and a profiler window), and (label, config, model
# fields replaced, batches) of the bwd split runs, whose stages are held
# bitwise; the ResNet-18 run also times its BatchNorm layers alone
SPLIT_ITERS = 1
SPLIT_BWD_RUNS = (("resnet18", "mpii_r18_384", {}, "32,128"),
                  ("resnet34", "mpii_r18_384", {"backbone": "resnet34"}, "32"),
                  ("resnet50", "mpii_r50_384", {}, "32"))
SPLIT_BN_LAYERS = 21       # ResNet-18's BatchNorms: stem, 16 in blocks, 3
                           # projections, the head's
SPLIT_TRAIN_BATCH, SPLIT_FWD_BATCH, SPLIT_CHECK_BATCH = 32, 128, 8
# (SPLIT_CHECK_BATCH: the images of the stage-composition checks)
TOOL_TOLERANCE = 3e-3    # about one joint in 378
# bf16 points known to miss TOOL_TOLERANCE on the card (bf16 rounding of the
# logits reorders crowded detections: ROADMAP queue 3). Each may miss by no
# more than the JAX package's own largest bf16-to-f32 gap at that tool's
# pinned points (7.3e-3 for the crowding study, at 6_person@0.6); any other
# miss fails.
TOOL_BF16_MISSES = {"crowd": ("random_1_to_12@0.6",)}
TOOL_PINS = {
    "oracle": ("mpii_r18_384", 64, 2, "0.9940"),
    "sweep": {
        "bf16": {"0.1/0.3": 0.988, "0.1/0.45": 0.988, "0.15/0.3": 0.988,
                 "0.15/0.45": 0.988, "0.2/0.3": 0.986, "0.2/0.45": 0.986},
        "f32": {"0.1/0.3": 0.988, "0.1/0.45": 0.988, "0.15/0.3": 0.988,
                "0.15/0.45": 0.988, "0.2/0.3": 0.986, "0.2/0.45": 0.986}},
    "sweep_tta": {
        "bf16": {"0.1/0.3": 0.9873, "0.1/0.45": 0.9933, "0.15/0.3": 0.9873,
                 "0.15/0.45": 0.9933, "0.2/0.3": 0.9867, "0.2/0.45": 0.9927},
        "f32": {"0.1/0.3": 0.988, "0.1/0.45": 0.994, "0.15/0.3": 0.988,
                "0.15/0.45": 0.994, "0.2/0.3": 0.9873, "0.2/0.45": 0.9933}},
    "crowd": {
        "exact": {"1_person": [1.0, 0.0, 1.0, 1.0, 1.0],
                  "3_person": [1.0, 0.0, 0.964, 0.9869, 0.9967],
                  "6_person": [0.9795, 0.0156, 0.833, 0.9323, 0.9545],
                  "random_1_to_12": [0.9329, 0.0625, 0.742, 0.8161, 0.8636]},
        "bf16": {"1_person@0.3": 0.9929, "1_person@0.45": 0.9929,
                 "1_person@0.6": 0.9929, "3_person@0.3": 0.9419,
                 "3_person@0.45": 0.9714, "3_person@0.6": 0.9714,
                 "6_person@0.3": 0.7883, "6_person@0.45": 0.8757,
                 "6_person@0.6": 0.8954, "random_1_to_12@0.3": 0.6654,
                 "random_1_to_12@0.45": 0.7273, "random_1_to_12@0.6": 0.7636},
        "f32": {"1_person@0.3": 0.9929, "1_person@0.45": 0.9929,
                "1_person@0.6": 0.9929, "3_person@0.3": 0.9419,
                "3_person@0.45": 0.9714, "3_person@0.6": 0.9714,
                "6_person@0.3": 0.7895, "6_person@0.45": 0.8789,
                "6_person@0.6": 0.9027, "random_1_to_12@0.3": 0.665,
                "random_1_to_12@0.45": 0.7252, "random_1_to_12@0.6": 0.7633}},
}

# phase 29: the train fields that make a tool's forward compute in a dtype
COMPUTE_FIELDS = {"bf16": {}, "f32": {"dtype": "float32"}}


def pretrained_run(name: str, label: str) -> dict:
    """``apps/train.main --pretrained`` on the card with a torchvision-key
    state dict made at run time from a seeded port backbone of ``name``'s
    kind (with the ``fc`` and ``num_batches_tracked`` entries torchvision
    files carry, which the loader drops). ``--steps 0`` writes the state
    before the first step, whose backbone must equal the file; ``--steps
    2`` then resumes from it and must log finite losses. Raises on a miss,
    naming ``label``."""
    from ppn_tpu_torch.apps import train as train_app
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.nn import resnet
    from ppn_tpu_torch.utils.torch_import import torchvision_state_dict

    make = getattr(resnet, get_config(name).model.backbone)
    torch.manual_seed(7)
    bb = make()
    sd = torchvision_state_dict(bb)
    sd["fc.weight"] = torch.randn(1000, bb.out_features)
    sd["fc.bias"] = torch.zeros(1000)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    with scratch_dir("pretrained_") as d:
        path = os.path.join(d, "backbone.pth")
        torch.save(sd, path)
        argv = ["--config", name, "--overfit", "8", "--batch-size",
                "8", "--ckpt-dir", os.path.join(d, "ckpt"), "--log-dir", d,
                "--pretrained", path, "--device", "cuda",
                "--set", "train.log_every=1"]
        quiet_call(train_app.main, argv + ["--steps", "0"])
        model = torch.load(os.path.join(d, "ckpt", "ckpt_00000000.pt"),
                           weights_only=True)["model"]
        bb = make()
        bb.load_state_dict({k[len("backbone."):]: v for k, v in model.items()
                            if k.startswith("backbone.")})
        got = torchvision_state_dict(bb)
        exact = (set(got) == {k for k in sd if not k.startswith("fc.")
                              and "num_batches" not in k}
                 and all(torch.equal(v, sd[k]) for k, v in got.items()))
        quiet_call(train_app.main, argv + ["--steps", "2"])
        losses = [r["loss_total"] for r in metrics(d)]
    pre = {"tensors": len(got), "equal_before_step_1": exact,
           "losses": losses}
    if (not pre["equal_before_step_1"] or len(pre["losses"]) != 2
            or not all(math.isfinite(v) for v in pre["losses"])):
        raise AssertionError(f"{label}: {pre}")
    return pre


def default(fn, name: str):
    """The default of ``fn``'s parameter ``name`` (a partial's bound value
    where it binds one), so each count below reads the sizes and
    repeats from the code that owns them."""
    return inspect.signature(fn).parameters[name].default


def slope_calls(iters: int) -> int:
    """Calls ``utils/profiling.device_latency_ms`` makes at ``iters``: one
    probe, then ``repeats`` runs each of ``iters`` and ``2·iters``."""
    from ppn_tpu_torch.utils.profiling import device_latency_ms

    return 1 + default(device_latency_ms, "repeats") * 3 * iters


def timeit_calls(iters: int) -> int:
    """Calls ``utils/profiling.timeit`` makes: ``warmup``, then
    ``repeats`` runs of ``iters``."""
    from ppn_tpu_torch.utils.profiling import timeit

    return default(timeit, "warmup") + default(timeit, "repeats") * iters


def serve_post_launches(point: dict, n: int, max_batch: int) -> int:
    """Post launches of one ``apps/serve.main`` self-test of ``n``
    requests: the warm-up (each power-of-two bucket up to ``max_batch``,
    uint8 and f32), one per served batch, and the check's direct predicts
    (``ceil(n / b)`` for each bucket b the server used)."""
    buckets = int(math.log2(max_batch)) + 1
    sizes = {int(b): c for b, c in point["batches_by_size"].items()}
    return (2 * buckets + sum(sizes.values())
            + sum(-(-n // b) for b in sizes))


def expected_bench_launches(c: str, rec: dict) -> tuple[int, int]:
    """(ppn_post_kernel, ppn_warp_kernel) launches config ``c`` of
    ``ppn_tpu_torch/bench/suite.py`` makes at its defaults, read from the
    bench function's signature and the timers'; where the count depends
    on the run (frames the video loop took, the server's batches), it is
    read from the record. The session reference is measured by config 1,
    which runs first, so no later config adds its calls."""
    from ppn_tpu_torch.bench import suite
    from ppn_tpu_torch.utils.profiling import latency_percentiles

    fn = suite._BENCHES[c]
    if c == "1":       # warm-up and timed calls, then the slope
        return (default(latency_percentiles, "warmup") + default(fn, "calls")
                + slope_calls(default(fn, "iters")), 0)
    if c in ("2", "4"):
        return timeit_calls(default(fn, "iters")), 0
    if c in ("3", "3b"):   # one warm-up step, the host loop, the slope
        return 0, (1 + default(fn, "iters")
                   + slope_calls(default(fn, "device_iters")))
    if c == "3c":      # the warm-up call's first step and its capture of
        return 0, 2    # a step's CUDA graph; the replays call no wrapper
    if c == "4b":
        return (timeit_calls(default(fn, "iters"))
                + slope_calls(default(fn, "device_iters")), 0)
    if c in ("5", "5p"):   # each processed frame, the warm-up frame
        return rec["frames"] + 1 + slope_calls(default(fn, "iters")), 0
    if c == "6":       # warm-up, the serial pass, the pipelined pass
        return 1 + 2 * rec["frames"], 0
    max_batch = default(suite.bench_serving, "max_batch")
    if c == "7":
        return serve_post_launches(rec, default(fn, "n"), max_batch), 0
    if c == "7w":
        return sum(serve_post_launches(p, default(fn, "n"), max_batch)
                   for p in rec["points"]), 0
    raise KeyError(c)


def crc32c_bitwise(data: bytes) -> int:
    """CRC-32C bit by bit (this script's own, not the event writer's table
    routine)."""
    c = 0xFFFFFFFF
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def read_tfrecords(path: str) -> list:
    """The payloads of a TFRecord file; raises on a bad length or payload
    CRC, or on a truncated record."""
    def masked(b: bytes) -> int:
        c = crc32c_bitwise(b)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        head = data[i:i + 8]
        n = int.from_bytes(head, "little")
        payload = data[i + 12:i + 12 + n]
        crcs = (int.from_bytes(data[i + 8:i + 12], "little"),
                int.from_bytes(data[i + 12 + n:i + 16 + n], "little"))
        if len(payload) != n or crcs != (masked(head), masked(payload)):
            raise AssertionError(f"{path}: bad record at byte {i}")
        out.append(payload)
        i += 16 + n
    return out


def proto_fields(buf: bytes) -> dict:
    """A protocol buffer message's fields: number → list of values (ints
    for varints, bytes for length-delimited and fixed-width fields)."""
    out, i = {}, 0

    def varint():
        nonlocal i
        v = shift = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return v
    while i < len(buf):
        key = varint()
        wire = key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n = varint()
            v, i = buf[i:i + n], i + n
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise AssertionError(f"wire type {wire}")
        out.setdefault(key >> 3, []).append(v)
    return out


def scalar_events(payloads: list) -> tuple:
    """The file version of the first ``Event`` and (step, tag, f32 bytes,
    plugin, data class) of each later one, each holding one scalar."""
    first = proto_fields(payloads[0])
    rows = []
    for p in payloads[1:]:
        ev = proto_fields(p)
        (value,) = proto_fields(ev[5][0])[1]
        v = proto_fields(value)
        tensor, meta = proto_fields(v[8][0]), proto_fields(v[9][0])
        step = ev.get(2, [0])[0]
        if tensor[1] != [1] or tensor[2] != [b""]:
            raise AssertionError(f"not a DT_FLOAT scalar: {tensor}")
        rows.append((step - (1 << 64) if step >> 63 else step,
                     v[1][0].decode(), tensor[4][0],
                     proto_fields(meta[1][0])[1][0].decode(), meta[4][0]))
    return first[3][0].decode(), rows


def batch_sha256(batch: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode() + str(batch[k].dtype).encode()
                 + str(batch[k].shape).encode() + batch[k].tobytes())
    return h.hexdigest()


def family_forwards(dev) -> dict:
    """Phase 28, part 3: each family model's eval forward on the card
    against the port's CPU path, the same seeded weights on both, on two
    seeded uint8 images: bf16 within BF16_TOL and f32 within FAMILY_F32_TOL
    of the largest CPU logit."""
    import copy

    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.nn.model import DTYPES, PoseProposalNet

    out = {}
    for name, backbone in FAMILY_FORWARDS:
        cfg = get_config(name)
        if backbone:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, backbone=backbone))
        images = torch.from_numpy(np.random.default_rng(28).integers(
            0, 256, (2, *cfg.model.insize, 3), dtype=np.uint8))
        label = f"{name}" + (f"+{backbone}" if backbone else "")
        for dtype, tol in (("bfloat16", BF16_TOL), ("float32",
                                                    FAMILY_F32_TOL)):
            torch.manual_seed(28)
            cpu = PoseProposalNet(cfg.model, dtype=DTYPES[dtype]).eval()
            card_model = copy.deepcopy(cpu).to(dev)
            with torch.no_grad():
                want = cpu(images)
                got = card_model(images.to(dev)).cpu()
            scale = float(want.abs().max())
            rel = float((got - want).abs().max()) / scale
            out[f"{label}_{dtype}"] = {"rel_to_max_logit": rel,
                                       "max_logit": scale, "limit": tol}
            if not (math.isfinite(rel) and rel <= tol):
                raise AssertionError(f"{label} {dtype}: card and CPU forwards"
                                     f" differ by {rel} of the largest logit")
            del cpu, card_model
    return out


def family_training_cli(root: str) -> dict:
    """Phase 28, part 5: ``apps/train.main`` at B=32, bf16, augmentation on,
    FAMILY_STEPS steps from a fresh init on an MPII JPEG tree
    (FAMILY_TRAIN_IMAGES training images, 16 held-out ones to evaluate),
    for ``mpii_r50_384`` and for ``mpii_r18_384 --backbone resnet34``."""
    out = {}
    for label, extra in (("mpii_r50_384", ["--config", "mpii_r50_384"]),
                         ("mpii_r18_384+resnet34", [
                             "--config", "mpii_r18_384", "--backbone",
                             "resnet34"])):
        run = train_cli(extra + [
            "--data", "mpii", "--data-root", os.path.join(root, "files"),
            "--steps", str(FAMILY_STEPS)], os.path.join(root, f"ckpt_{label}"))
        run.pop("printed")
        evals = [e["pckh/mean"] for e in run.pop("evals")]
        out[label] = dict(run, eval_pckh=evals[0] if evals else None)
        losses, warp, post = (run[k] for k in ("losses", "warp_launches",
                                               "post_launches"))
        if (len(losses) != FAMILY_STEPS or warp != FAMILY_STEPS or post != 2
                or not all(math.isfinite(v) for v in losses)
                or len(evals) != 1 or not math.isfinite(evals[0])):
            raise AssertionError(f"train CLI {label}: {out[label]}")
    return out


def bottleneck_card_vs_cpu(cin: int, cout: int, stride: int, side: int,
                           dev) -> dict:
    """One f32 ``Bottleneck`` in training mode on the card against the same
    block on the CPU: seeded weights (BatchNorm scales and biases moved off
    1 and 0), a seeded (2, cin, side, side) input and a seeded linear loss.
    The CPU replays the card's ReLU decisions: a pre-activation within
    rounding of 0 can fall on the other side, and through the BatchNorm
    backward one such tie moves its whole channel's gradients, so the
    comparison holds the arithmetic, with the ties counted. Returns the
    worst |Δ| over the largest |value| and its tensor for the output, the
    gradients (every parameter's and the input's) and the running
    statistics; the ReLU decisions the CPU would have made otherwise; and
    the worst gradient when the CPU makes its own decisions."""
    import copy

    from ppn_tpu_torch.nn import resnet
    from ppn_tpu_torch.ops import cuda_bn

    torch.manual_seed(15)
    init = resnet.Bottleneck(cin, cout, stride, dtype=torch.float32).train()
    rng = np.random.default_rng(15)
    with torch.no_grad():
        for n, p in init.named_parameters():
            if p.ndim == 1:
                p.copy_(torch.from_numpy((0.1 * rng.standard_normal(
                    p.shape) + (n.endswith("weight"))).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal(
        (2, cin, side, side)).astype(np.float32))
    out_side = side // stride
    r = torch.from_numpy(rng.standard_normal(
        (2, cout * 4, out_side, out_side)).astype(np.float32))
    masks, replay = [], {"on": False, "next": 0, "ties": 0}

    class Functional:
        """torch.nn.functional with ``relu`` recording its masks (the
        card's run) or applying the recorded ones in order (the CPU's)."""
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def relu(t):
            if not replay["on"]:
                masks.append(t > 0)
                return t * masks[-1]
            m = masks[replay["next"]].to(t.device)
            replay["next"] += 1
            replay["ties"] += int(((t > 0) != m).sum())
            return t * m

    def run(block, device):
        xt = x.to(device).requires_grad_()
        y = block(xt)
        names, params = zip(*block.named_parameters())
        grads = torch.autograd.grad((y * r.to(device)).sum(), (xt, *params))
        return ({"output": y.detach().cpu()},
                {n: g.cpu() for n, g in zip(("input", *names), grads)},
                {n: b.cpu() for n, b in block.named_buffers()})

    # on the card the ReLUs after conv1's and conv2's BatchNorm run inside
    # the ppn_bn_* kernels: their decisions are read off those layers'
    # outputs (positive where the pre-activation was), in call order with
    # the residual ReLU's; on the CPU all three go through ``F.relu``
    card_block = copy.deepcopy(init).to(dev)
    hooks = [m.register_forward_hook(
        lambda layer, args, y: masks.append(y > 0))
        for m in card_block.modules()
        if isinstance(m, resnet.BatchNorm) and m.act == "relu"]
    functional = resnet.F, cuda_bn.F
    resnet.F = cuda_bn.F = Functional()
    try:
        got = run(card_block, dev)
        for h in hooks:
            h.remove()
        replay["on"] = True
        want = run(copy.deepcopy(init), "cpu")
    finally:
        resnet.F, cuda_bn.F = functional
    out = {k: max_rel_state(g, w) for k, g, w in zip(
        ("output", "gradients", "statistics"), got, want)}
    out["relu_ties"] = replay["ties"]
    out["own_decisions_gradients"] = max_rel_state(got[1], run(init, "cpu")[1])
    return out


def split_warp_launches(iters: int, rec: dict) -> int:
    """``ppn_warp_kernel`` launches of one ``tools/torch_train_split.py``
    run of every variant at ``iters``: ``full``'s first step, its host loop
    and its profiler windows; ``augment_only``'s and ``full_body``'s slopes
    and windows (``no_augment`` and the rest warp nothing). The windows a
    row ran are read from its record (``device_busy_ms`` runs one again
    when the profiler left kernels unrecorded)."""
    from ppn_tpu_torch.utils.profiling import device_busy_ms

    calls = default(device_busy_ms, "calls")
    window = {k: calls * rec["device_busy_ms"][k]["windows"]
              for k in ("full", "augment_only", "full_body")}
    return ((1 + iters + window["full"])
            + (slope_calls(iters) + window["augment_only"])
            + (slope_calls(max(4, iters // 2)) + window["full_body"]))


def split_checks(dev) -> dict:
    """Phase 30's checks, each on fresh models, under cuDNN's
    deterministic algorithms: bwd_split's stages composed against
    ``backbone(x)`` for each backbone of ``SPLIT_BWD_RUNS``, fwd_split's
    ``ingest`` ∘ ``blocks`` ∘ ``head`` against ``model(img)`` (bitwise),
    and the s2d stem against the 7×7 stem within ``BF16_TOL`` of the
    largest value, on the tool's own model and images. (The train split's
    ``full_body`` is ``train_step`` itself, on a ``copy_state`` copy.)"""
    from ppn_tpu_torch import configs
    from ppn_tpu_torch.testing import replacing_config
    from ppn_tpu_torch.train.steps import create_train_state
    from tools import torch_bwd_split, torch_fwd_split

    out = {}
    cfg = configs.get_config("mpii_r18_384")
    image = torch.rand((SPLIT_CHECK_BATCH, *cfg.model.insize, 3),
                       generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    out["stages_compose"] = {}
    for label, name, fields, _ in SPLIT_BWD_RUNS:
        with replacing_config(model=fields):    # read at call time
            model = create_train_state(configs.get_config(name),
                                       device=dev).model.train()
        inputs = torch_bwd_split.stage_inputs(model, image)
        with torch.no_grad():
            whole = model.backbone(inputs["stem"])
        out["stages_compose"][label] = {
            "stages": [len(s) for s in model.backbone.stages()],
            "bitwise": bool(torch.equal(inputs["head"], whole)),
            "channels_last": inputs["head"].is_contiguous(
                memory_format=torch.channels_last)}

    model = create_train_state(cfg, seed=0, device=dev).model.eval()
    img = torch.from_numpy(np.random.default_rng(0).random(
        (SPLIT_FWD_BATCH, *cfg.model.insize, 3), np.float32)).to(dev)
    with torch.no_grad():
        split = torch_fwd_split.head(model, torch_fwd_split.blocks(
            model, torch_fwd_split.ingest(model, img)))
        out["fwd_split_is_model"] = bool(torch.equal(split, model(img)))
        stems = torch_fwd_split.stem_variants(model)
        a7, s2d = stems["stem7"](img).float(), stems["s2d"](img).float()
    out["s2d_max_abs_diff"] = float((a7 - s2d).abs().max())
    out["stem7_max_abs"] = float(a7.abs().max())
    return out


def split_busy_rows(out: dict):
    """(tool run, row, its device_busy_ms) of every row of phase 30's
    records."""
    for label, rec in out.items():
        if label.startswith("bwd_split"):
            for b in rec["batches"]:
                rows = {**b["stages"], **(
                    {"batch_norm": b["batch_norm"]} if "batch_norm" in b
                    else {})}
                for name, st in rows.items():
                    for kind, busy in st["device_busy_ms"].items():
                        yield label, f"B={b['batch']} {name} {kind}", busy
        elif label in ("train_split", "fwd_split"):
            for row, busy in rec["device_busy_ms"].items():
                yield label, row, busy


def model_points(label: str, run, pins: dict) -> dict:
    """Phase 29's check of a tool's model PCKh points: ``run(dtype)`` runs
    the tool with its forward computing in ``dtype`` ("bf16", the config's
    own, or "f32") and returns {point: PCKh}; both run every time. In f32
    every point must be within TOOL_TOLERANCE of the JAX package's f32
    value: a fault of the port shows there. In bf16 every point must be
    within TOOL_TOLERANCE of the JAX package's bf16 value, except a point
    named in TOOL_BF16_MISSES, which may miss by no more than the JAX
    package's own largest bf16-to-f32 gap at this tool's points."""
    gap = max(abs(pins["bf16"][k] - pins["f32"][k]) for k in pins["bf16"])
    known = TOOL_BF16_MISSES.get(label, ())
    out = {}
    for dtype in ("bf16", "f32"):
        got, want = run(dtype), pins[dtype]
        if set(got) != set(want):
            raise AssertionError(f"{label}: points {sorted(got)}, pinned "
                                 f"{sorted(want)}")
        misses = {k: [v, want[k]] for k, v in got.items()
                  if not abs(v - want[k]) <= TOOL_TOLERANCE}
        bad = {k: m for k, m in misses.items() if dtype == "f32"
               or k not in known or not abs(m[0] - m[1]) <= gap}
        out[dtype] = {"points": got, "misses": misses}
        if bad:
            raise AssertionError(f"{label} ({dtype}): points {got}, pinned "
                                 f"{want}, failing {bad}")
    return out


def exported_pipeline(ctx) -> dict:
    """Phase 20: the pipeline exported at B=8, to bytes and back: ``valid``
    equal to ``Predictor.predict``'s on the protocol's first 8 images,
    floats within 4 ulps; sizes and times beside the plain post-process's
    bounded NMS and early-exit loop."""
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import max_ulp
    from ppn_tpu_torch.utils.export import export_pipeline, load_pipeline

    cfg, val, dev, B = ctx.cfg, ctx.val, ctx.dev, 8
    pred = Predictor.from_npz(cfg, SNAPSHOT)
    # the pipeline is exported for f32 images in [0, 1]; the protocol's are
    # uint8, and both sides get the same floats
    images = np.stack([val[i]["image"] for i in range(B)]).astype(
        np.float32) / np.float32(255.0)
    t0 = time.perf_counter()
    blob = export_pipeline(cfg, pred.model, batch=B, device=dev)
    t1 = time.perf_counter()
    run = load_pipeline(blob)
    t2 = time.perf_counter()
    cuda_post.LAUNCHES = 0
    kp_box, kp_score, valid = (t.cpu().numpy() for t in run(images))
    exported_launches = cuda_post.LAUNCHES
    want = pred.predict(images)
    equal = np.array_equal(valid, want.valid)
    ulp = max(max_ulp(kp_box[want.valid], want.kp_box[want.valid]),
              max_ulp(kp_score[want.valid], want.kp_score[want.valid]))

    def exported_call():
        run(images)
        torch.cuda.synchronize()

    for _ in range(3):
        exported_call()
        pred.predict(images)
    exp_ms = statistics.median(
        1e3 * timed(exported_call) for _ in range(20))
    pred_ms = statistics.median(
        1e3 * timed(lambda: pred.predict(images)) for _ in range(20))
    with torch.no_grad():
        fm = pred.model(torch.from_numpy(images).to(dev))
    m = cfg.model
    bounded_ms = time_ms(lambda: postprocess_batch_plain(m, fm, bounded=True),
                         5)
    early_ms = time_ms(lambda: postprocess_batch_plain(m, fm), 5)
    exp = {"valid_equal": equal, "max_ulp": ulp,
           "persons": int(want.valid.sum()), "bytes": len(blob),
           "export_s": t1 - t0, "load_s": t2 - t1,
           "exported_ms_b8": exp_ms, "predict_ms_b8": pred_ms,
           "post_launches_exported": exported_launches,
           "plain_post_bounded_ms_b8": bounded_ms,
           "plain_post_early_exit_ms_b8": early_ms}
    if not exp["valid_equal"] or exp["max_ulp"] > ULP_LIMIT:
        raise AssertionError(f"exported pipeline disagrees: {exp}")
    return {"ninth_slice": {"export": exp}, "kernels": {"ppn_post_kernel": {
        "launches_exported_pipeline": exp["post_launches_exported"]}}}


def pretrained(ctx) -> dict:
    """Phase 21: ``pretrained_run`` of a seeded ResNet-18."""
    return {"ninth_slice": {"pretrained": pretrained_run(
        "mpii_r18_384", "[pretrained] apps/train.main --pretrained")}}


def profiling_debug(ctx) -> dict:
    """Phase 22: ``profiling.trace`` of one predict names ``ppn_post_kernel``;
    ``device_latency_ms`` of the post kernel at B=1 beside phase 6's graph
    time; a NaN forward raises under ``debug.checking()`` and passes
    outside it."""
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.utils import debug, profiling

    cfg, val, dev = ctx.cfg, ctx.val, ctx.dev
    graph_b1 = ctx.records["predict_b128"]["post_ms"][1]
    pred = Predictor.from_npz(cfg, SNAPSHOT)
    images = np.stack([val[i]["image"] for i in range(8)])
    pred.predict(images)
    with scratch_dir("trace_") as d:
        with profiling.trace(d, device=dev):
            pred.predict(images)
        with open(os.path.join(d, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    post = [e for e in kernels if e["name"].startswith("ppn_post_kernel")]
    x1 = torch.from_numpy(images[:1]).to(dev)
    with torch.no_grad():
        fm1 = pred.model(x1)
    call = functools.partial(cuda_post.postprocess_batch_cuda, cfg.model,
                             fm1)
    latency = profiling.device_latency_ms(call, iters=200, repeats=5)
    wrapper_us = host_us(call, 200)
    nan = torch.full(x1.shape, float("nan"), device=dev)
    with torch.no_grad():
        unchecked = bool(torch.isnan(pred.model(nan)).any())
        try:
            with debug.checking():
                pred.model(nan)
            raised = ""
        except FloatingPointError as e:
            raised = str(e)
    prof = {"kernels_in_trace": len(kernels), "post_in_trace": len(post),
            "post_trace_us": sum(e.get("dur", 0) for e in post),
            "post_device_latency_ms_b1": latency,
            "post_wrapper_host_us_b1": wrapper_us,
            "nan_passes_unchecked": unchecked, "checking_raised": raised,
            "post_graph_ms_b1": graph_b1}
    if (not prof["post_in_trace"] or not prof["checking_raised"]
            or not prof["nan_passes_unchecked"]):
        raise AssertionError(f"profiling/debug: {prof}")
    return {"ninth_slice": {"profiling": prof}}


def native_decode(ctx) -> dict:
    """Phase 23: the evaluate CLI on the protocol images as 960² JPEGs
    through the native decoder: PCKh 0.976190 ± 3e-3 over exactly 378
    joints (the JAX package's value), two post launches; the files' and
    decoded arrays' sha256 against the reference's (a report); decode and
    pool rates; the video CLI through the pool, its first frame's decisions
    equal to the plain pipeline's."""
    import hashlib

    import PIL
    from PIL import features

    from ppn_tpu_torch.apps import evaluate, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.imageio import load_resized
    from ppn_tpu_torch.data.synthetic import heldout_dataset
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.native import loader as nl
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.testing import write_mpii_set

    model = Predictor.from_npz(ctx.cfg, SNAPSHOT).model
    cfg = get_config("mpii_r18_384")
    hw = cfg.model.insize
    out = {"pil": PIL.__version__,
           "libjpeg_turbo": features.version("libjpeg_turbo"),
           "pillow_libjpeg": str(nl.libjpeg())}
    with scratch_dir("native_") as d:
        held = heldout_dataset(cfg, num_persons=2)
        write_mpii_set(cfg, d, {"train": (held, 16, 0),
                                "valid": (held, 16, 0)}, "jpg",
                       scale=NATIVE_SCALE)
        images = os.path.join(d, "images")
        files = [os.path.join(images, n) for n in sorted(os.listdir(images))]
        blobs = []
        for path in files:
            with open(path, "rb") as fh:
                blobs.append(fh.read())
        decoded = hashlib.sha256()
        for b in blobs:
            decoded.update(nl.decode_resize(b, hw).tobytes())
        out.update(files=sha256_of(images), decoded=decoded.hexdigest(),
                   dims=nl.jpeg_dims(blobs[0]))
        out["same_as_reference"] = {k: out[k] == NATIVE_SET_ORIGIN[k]
                                    for k in NATIVE_SET_ORIGIN}

        # the evaluate CLI at its default decoding (native for JPEGs)
        pin, joints = NATIVE_PIN
        cuda_post.LAUNCHES = 0
        summary, _ = quiet_call(evaluate.main, [
            "--config", "mpii_r18_384", "--data", "mpii", "--data-root", d,
            "--ckpt-dir", SNAPSHOT, "--max-images", "16", "--batch-size",
            "8", "--detection-thresh", "0.02", "--nms-thresh", "0.45"])
        launches = cuda_post.LAUNCHES
        out["evaluate"] = dict(summary, launches=launches, pinned=pin)
        if (abs(summary["pckh/mean"] - pin) >= 3e-3
                or summary["pckh/num_joints"] != joints or launches != 2):
            raise AssertionError(f"native-decoded evaluation: {out}")

        # decode times: one-shot native and PIL on the same files, the pool
        def per_image_ms(fn, items, passes=3):
            times = []
            for _ in range(passes):
                t0 = time.perf_counter()
                for item in items:
                    fn(item)
                times.append(1e3 * (time.perf_counter() - t0) / len(items))
            return statistics.median(times)

        out["decode_ms"] = {
            "native": per_image_ms(lambda b: nl.decode_resize(b, hw), blobs),
            "pil": per_image_ms(lambda f: load_resized(f, hw,
                                                       native_jpeg=False),
                                files)}
        rates = {}
        for workers in (4, 8):
            pool = nl.NativeJpegLoader(hw, num_workers=workers)
            try:
                t0 = time.perf_counter()
                for i in range(POOL_JOBS):
                    pool.submit(i, blobs[i % len(blobs)])
                got = [pool.get()[1] is not None for _ in range(POOL_JOBS)]
                dt = time.perf_counter() - t0
            finally:
                pool.close()
            if not all(got):
                raise AssertionError("the pool failed a protocol JPEG")
            rates[workers] = POOL_JOBS / dt
        out["pool_img_per_s"] = rates

        # video from the directory through the pool
        vcfg = get_config("mpii_r18_384")
        frame0 = next(video.jpeg_frames(images, 1, vcfg.model.insize))
        equal, ulp, _ = frame_vs_plain(vcfg, model, frame0)
        summary = video_cli([
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            images, "--frames", str(FILE_VIDEO_FRAMES)])
        out["video"] = dict(summary, first_frame_decisions_equal=equal,
                            first_frame_max_ulp=ulp)
        if not equal or ulp > ULP_LIMIT:
            raise AssertionError(f"video through the pool: {out['video']}")
    return {"eleventh_slice": {"native_decode": out}, "kernels": {
        "ppn_post_kernel": {"launches_native_files": (
            out["evaluate"]["launches"] + out["video"]["launches"])}}}


def bench_suite(ctx) -> dict:
    """Phase 26: ``bench/suite.main`` one config at a time (then 1 and 2
    again): each value finite and positive on this card, no serving
    mismatch, each config's launches of both kernels what its code implies
    (``expected_bench_launches``); then the headline as a subprocess."""
    from ppn_tpu_torch.bench import suite
    from ppn_tpu_torch.ops import cuda_post, cuda_warp

    card = ctx.card
    records, launches, seconds = {}, {}, {}
    with tempfile.TemporaryDirectory() as d:
        for c in BENCH_CONFIGS + ("1", "2"):
            again = c in records
            cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
            t0 = time.perf_counter()
            path = os.path.join(d, f"{c}.json")
            suite.main(["--configs", c, "--out", path])
            key = f"{c}_again" if again else c
            seconds[key] = time.perf_counter() - t0
            launches[key] = (cuda_post.LAUNCHES, cuda_warp.LAUNCHES)
            with open(path) as f:
                (records[key],) = json.load(f)
    for key, rec in records.items():
        c = key.split("_")[0]
        want = expected_bench_launches(c, rec)
        log(f"[bench] {key}: {rec['config']} {rec['metric']} {rec['value']} "
            f"{rec['unit']}; launches ppn_post_kernel {launches[key][0]}, "
            f"ppn_warp_kernel {launches[key][1]} (the code implies {want}); "
            f"{seconds[key]:.1f} s | {rec['card']}")
        if not (isinstance(rec["value"], (int, float))
                and math.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"bench {key}: value {rec['value']!r}")
        if launches[key] != want:
            raise AssertionError(f"bench {key}: launches {launches[key]}, "
                                 f"the code implies {want}")
        if rec["card"] != card:
            raise AssertionError(f"bench {key}: card {rec['card']!r}")
    for rec in (records["7"], *records["7w"]["points"]):
        if rec["selftest_rc"] != 0 or rec["mismatches"] != 0:
            raise AssertionError(f"bench serving mismatches: {rec}")
    if not 0 < records["4b"]["mfu_pct"] <= 100:
        raise AssertionError(f"bench 4b mfu_pct {records['4b']['mfu_pct']}")
    if records["6"]["frames"] != 96:
        raise AssertionError(f"bench 6 frames {records['6']['frames']}")

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ppn_tpu_torch.bench.headline"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds["headline"] = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"headline rc {r.returncode}, stdout "
                             f"{r.stdout!r}, stderr {r.stderr[-2000:]!r}")
    head = json.loads(lines[0])
    if (set(head) != HEADLINE_KEYS or not 0 < head["mfu_pct"] <= 100
            or not head["value"] > 0 or head["card"] != card):
        raise AssertionError(f"headline line: {head}")
    return {"bench_suite": {"records": records, "launches": launches,
                            "seconds": seconds, "headline": head},
            "kernels": {
                "ppn_post_kernel": {"launches_bench_suite": {
                    k: v[0] for k, v in launches.items() if v[0]}},
                "ppn_warp_kernel": {"launches_bench_suite": {
                    k: v[1] for k, v in launches.items() if v[1]}}}}


def parity_leftovers(ctx) -> dict:
    """Phase 27: ``make_grain_loader`` at 4 workers bitwise 0; 10
    ``train_step`` calls on its batches, 10 warp launches; their terms
    through ``MetricLogger(tensorboard=True)`` read back by
    ``read_tfrecords`` (every CRC, every event); ``num_params`` equal to
    ``MPII_R18_384_PARAMS``."""
    from ppn_tpu_torch.data.pipeline import make_grain_loader
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.nn import num_params
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.logging import MetricLogger
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    tcfg = constant_lr(ctx.cfg)
    B = tcfg.train.batch_size
    ds = SyntheticPoseDataset(tcfg, size=PARITY_IMAGES, seed=0)
    epochs = PARITY_STEPS * B // PARITY_IMAGES
    loads = {}
    for workers in (PARITY_WORKERS, 0):
        t0 = time.perf_counter()
        batches = list(make_grain_loader(ds, B, seed=0, num_workers=workers,
                                         num_epochs=epochs))
        loads[workers] = (batches, time.perf_counter() - t0)
    hashes = {w: [batch_sha256(b) for b in v[0]] for w, v in loads.items()}
    batches = loads[PARITY_WORKERS][0]
    img_s = {w: len(v[0]) * B / v[1] for w, v in loads.items()}
    del loads
    state = load_npz_into_train_state(
        tcfg, SNAPSHOT, st.create_train_state(tcfg, device=ctx.dev))
    with scratch_dir("leftovers_") as d:
        logger = MetricLogger(d, stdout=False, tensorboard=True)
        logged, ms = [], []
        torch.cuda.synchronize(ctx.dev)
        cuda_warp.LAUNCHES = 0
        for step, batch in enumerate(batches, 1):
            t0 = time.perf_counter()
            terms = st.train_step(tcfg, state, batch, augment=True)
            terms = {k: float(v) for k, v in terms.items()}
            ms.append(1e3 * (time.perf_counter() - t0))
            logger.log(step, terms)
            logged.append(terms)
        launches = cuda_warp.LAUNCHES
        logger.close()
        (path,) = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
                   if f.startswith("events.out.tfevents.")]
        payloads = read_tfrecords(path)
        version, rows = scalar_events(payloads)
        want = [(step, k, np.float32(v).tobytes(), "scalars", 1)
                for step, terms in enumerate(logged, 1)
                for k, v in terms.items()]
        rel = os.path.relpath(path, d)
    out = {"hashes_equal": hashes[PARITY_WORKERS] == hashes[0],
           "batches": len(batches), "first_batch_sha256": hashes[0][0],
           "warp_launches": launches, "event_file": rel,
           "records": len(payloads),
           "records_expected": 1 + sum(len(t) for t in logged),
           "file_version": version, "events_equal": rows == want,
           "num_params": num_params(state.model),
           "finite": all(math.isfinite(v) for t in logged
                         for v in t.values()),
           "loss_total": [t["loss_total"] for t in logged],
           "loader_img_per_s": {str(w): v for w, v in img_s.items()},
           "step_ms_median": statistics.median(ms), "step_ms_all": ms}
    if (not out["hashes_equal"] or len(batches) != PARITY_STEPS
            or launches != PARITY_STEPS or not out["finite"]
            or out["records"] != out["records_expected"]
            or version != "brain.Event:2" or not out["events_equal"]
            or out["num_params"] != MPII_R18_384_PARAMS):
        raise AssertionError(f"parity leftovers: {out}")
    return {"parity_leftovers": out, "kernels": {"ppn_warp_kernel": {
        "launches_parity_leftovers": out["warp_launches"]}}}


def model_family(ctx) -> dict:
    """Phase 28: the rest of the JAX package's models at full width: both
    kernels at 224² against their plain versions, and timed; the family's
    forwards, card against CPU; ResNet-50 predict at B=128; the train CLI
    for ResNet-50 and -34; an f32 ResNet-50 step, ``sgd_update`` and two
    Bottleneck blocks against the CPU; a ResNet-50 overfit kept as phase
    29's checkpoint; ``--pretrained``; 224² video."""
    from ppn_tpu_torch.apps import video
    from ppn_tpu_torch.bench.suite import forward_flops, peak_bf16_tflops
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                              heldout_dataset)
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import affine_warp_separable_plain
    from ppn_tpu_torch.testing import KINDS, feature_map_case, write_mpii_set
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.checkpoint import Checkpointer

    images, fixed = ctx.images, ctx.fixed
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}

    # 1. the post kernel at 7×7 (its 9×9 window reaches past the grid from
    # every cell): the seeded kinds, the edge maps, the NaN window case
    m = get_config("mpii_r18_224_fast").model
    out["post_max_ulp"], out["post_max_abs_err"] = 0, 0.0
    for B, kind in ([(B, kind) for B in (1, 32, 128) for kind in KINDS]
                    + [(8, "empty"), (8, "chain")]):
        ulp, err = check_post(m, B, kind, "[family] ppn_post_kernel 7x7")
        out["post_max_ulp"] = max(out["post_max_ulp"], ulp)
        out["post_max_abs_err"] = max(out["post_max_abs_err"], err)
    check_nan_window(m, "[family] ppn_post_kernel 7x7")

    # 2. the warp kernel at 224², bitwise; both kernels timed there
    fast = get_config("mpii_r18_224_fast")
    rng = np.random.default_rng(224)
    x224 = torch.from_numpy(rng.random((32, 224, 224, 3), np.float32)).to(dev)
    mats = warp_matrices(fast, 32, dev, seed=224)
    warp_err, _ = check_warp(x224, mats,
                             "[family] ppn_warp_kernel 224x224x3 B=32")
    xw = x224.to(torch.bfloat16)
    wcall = functools.partial(cuda_warp.affine_warp_cuda, xw, mats)
    out["warp"] = {"ms": graph_ms(wcall, 50), "bound_ms": warp_bound_ms(xw),
                   "plain_ms": time_ms(
                       lambda: affine_warp_separable_plain(xw, mats), 5),
                   "max_abs_err": warp_err}
    fpred = Predictor.from_checkpoint(fast, None)   # the seeded init
    m = fast.model
    out["post"] = {}
    images224 = torch.from_numpy(rng.integers(0, 256, (128, 224, 224, 3),
                                              dtype=np.uint8)).to(dev)
    for b in (1, 128):
        with torch.no_grad():
            main_map = fpred.model(images224[:b])
        for kind, fm in (("main", main_map), ("normal", torch.from_numpy(
                feature_map_case(m, b, seed=b)).to(dev))):
            out["post"][f"{kind}_b{b}"] = post_time(m, fm)

    # 3. forwards, card against CPU
    out["forwards"] = family_forwards(dev)

    # 4. inference, mpii_r50_384 at B=128
    r50 = get_config("mpii_r50_384")
    pred = Predictor.from_checkpoint(r50, None)
    calls = 0

    def predict():
        nonlocal calls
        calls += 1
        return pred.predict(images)

    cuda_post.LAUNCHES = 0
    for _ in range(3):
        ppl = predict()
    if not all(np.isfinite(getattr(ppl, f)).all() for f in FLOATS):
        raise AssertionError("non-finite ResNet-50 predictions")
    med = statistics.median(event_times(predict, 20))
    flops = forward_flops(r50, 1)
    ips = 1e3 * images.shape[0] / med
    out["r50_predict"] = {
        "ms_median": med, "img_per_s": ips, "forward_gflop_per_image":
        flops / 1e9, "mfu_pct": flops * ips / (
            peak_bf16_tflops(dev) * 1e12) * 100.0,
        "launches": cuda_post.LAUNCHES, "calls": calls}
    if cuda_post.LAUNCHES != calls:
        raise AssertionError(f"{cuda_post.LAUNCHES} post launches in {calls}"
                             " ResNet-50 predict calls")
    del pred, ppl

    d = tempfile.mkdtemp(prefix="family_", dir=os.path.join(ROOT, "build"))
    ckpt = os.path.join(d, "overfit_r50")
    # 5. the train CLI on files: ResNet-50 and ResNet-34
    mpii = get_config("mpii_r18_384")
    write_mpii_set(mpii, os.path.join(d, "files"), {
        "train": (SyntheticPoseDataset(mpii, size=FAMILY_TRAIN_IMAGES,
                                       seed=0, cache=True, num_persons=2),
                  FAMILY_TRAIN_IMAGES, 0),
        "valid": (heldout_dataset(mpii, num_persons=2), 16, 10_000)}, "jpg")
    out["train_cli"] = family_training_cli(d)

    # 6. one f32 ResNet-50 step, card against CPU, from the same state: the
    # loss terms and grad_norm held, the gradients (after a first step from
    # zero momentum each trace is the decayed gradient g + wd·p) and the
    # state after the update recorded
    tcfg = dataclasses.replace(r50, train=dataclasses.replace(
        r50.train, dtype="float32", lr_schedule="constant",
        warmup_steps=0, ema_decay=0.9))
    sd0 = {k: v.clone() for k, v in st.create_train_state(
        tcfg, device="cpu").model.state_dict().items()}
    batch = DeviceCache(SyntheticPoseDataset(r50, size=2, seed=1),
                        device="cpu").batch([0, 1])
    image = batch["image"].cpu().float() / 255.0   # as the model reads uint8
    nudged = torch.nextafter(image, torch.full_like(image, 2.0))

    def step(device, img):
        state = st.create_train_state(tcfg, device=device)
        state.model.load_state_dict(sd0)
        terms = st.train_step(tcfg, state, dict(batch, image=img))
        return state, {k: float(v) for k, v in terms.items()}

    def apart(a, b):        # (grad_norm rel, worst gradient tensor ·max|g|)
        (sa, ta), (sb, tb) = a, b
        return (abs(ta["grad_norm"] - tb["grad_norm"]) / tb["grad_norm"],
                *max_rel_state({n: t.cpu() for n, t in sa.trace.items()},
                               {n: t.cpu() for n, t in sb.trace.items()}))

    (cpu_state, want), (gpu_state, got) = cpu_run, gpu_run = (
        step("cpu", image), step(dev, image))
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    grad_rel, grad_worst = apart(gpu_run, cpu_run)[1:]
    # the same step with every pixel one f32 ulp up, on each side
    nudge = {side: apart(step(device, nudged), run) for side, device, run in (
        ("cpu", "cpu", cpu_run), ("card", dev, gpu_run))}
    state_rel, state_worst = max_rel_state(
        {n: t.cpu() for n, t in gpu_state.model.state_dict().items()},
        cpu_state.model.state_dict())
    out["f32_step"] = {"rel": rel, "grad_rel": grad_rel,
                       "grad_worst_tensor": grad_worst,
                       "state_rel": state_rel,
                       "state_worst_tensor": state_worst, "nudge": nudge}
    terms_rel = max(v for k, v in rel.items() if k != "grad_norm")
    if (terms_rel > FAMILY_STEP_REL
            or rel["grad_norm"] > FAMILY_GRAD_NORM_REL):
        raise AssertionError(f"ResNet-50 card and CPU steps disagree: "
                             f"{out['f32_step']}")
    # the update from the same state (the CPU's after that step, copied to
    # the card) on the same gradients: seeded, one per parameter
    with torch.no_grad():
        gpu_state.model.load_state_dict(cpu_state.model.state_dict())
        for part in ("trace", "ema"):
            for n, t in getattr(gpu_state, part).items():
                t.copy_(getattr(cpu_state, part)[n])
    rng = np.random.default_rng(15)
    grads = {n: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32))
        for n, p in cpu_state.model.named_parameters()}
    st.sgd_update(tcfg, cpu_state, grads)
    st.sgd_update(tcfg, gpu_state, {n: g.to(dev) for n, g in grads.items()})
    update = {}
    for part in ("model", "trace", "ema"):
        a, b = ((s.model.state_dict() if part == "model"
                 else getattr(s, part)) for s in (gpu_state, cpu_state))
        update[part] = max_rel_state({n: t.cpu() for n, t in a.items()}, b)
    out["f32_step"]["update_rel"] = update
    if max(v for v, _ in update.values()) > UPDATE_TOL:
        raise AssertionError(f"sgd_update, card vs CPU: {update}")
    del cpu_state, gpu_state, cpu_run, gpu_run
    out["blocks"] = {}
    for cin, cout, stride, side in FAMILY_BLOCKS:
        worst = bottleneck_card_vs_cpu(cin, cout, stride, side, dev)
        key = f"{cin}->{cout}x4/s{stride}@{side}"
        out["blocks"][key] = worst
        if (max(worst["output"][0], worst["gradients"][0]) > BLOCK_TOL
                or worst["statistics"][0] > BLOCK_STATS_TOL):
            raise AssertionError(f"Bottleneck {key}: {worst}")

    # 7. overfit the 8 fixed images from a fresh init, kept for phase 29
    ostate, first, tail = overfit(r50, fixed, dev,
                                  "[family] mpii_r50_384 overfit:")
    out["overfit"] = {"first": first, "last10_mean": tail}
    Checkpointer(ckpt).save(OVERFIT_STEPS, ostate)
    del ostate

    # 8. --pretrained with a torchvision-layout ResNet-50
    out["pretrained"] = pretrained_run(
        "mpii_r50_384", "[family] apps/train.main --pretrained, ResNet-50")

    # 9. video at 224² (the seeded init: no 224² snapshot exists)
    frame0 = next(video.synthetic_frames(1, fps=0))
    equal, ulp, persons = frame_vs_plain(fast, fpred.model, frame0)
    log(f"[family] first 720p frame through the 224² pipeline against the "
        f"plain pipeline: decisions_equal={equal} max_ulp={ulp} persons "
        f"{persons}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("224² video pipeline disagrees with the plain "
                             "one")
    out["video"] = video_cli([
        "--config", "mpii_r18_224_fast", "--source", "synthetic",
        "--frames", str(VIDEO_FRAMES)])
    out["seconds"] = time.perf_counter() - t_phase
    return {"model_family": out, "overfit_ckpt": ckpt, "kernels": {
        "ppn_post_kernel": {
            "max_ulp": out["post_max_ulp"],
            "max_abs_err": out["post_max_abs_err"],
            "launches_model_family": {
                "mpii_r50_384_predict": out["r50_predict"]["launches"],
                "train_cli_evaluate": {k: v["post_launches"] for k, v in
                                       out["train_cli"].items()},
                "video_224": out["video"]["launches"]},
            "ms_7x7": {k: v["ms"] for k, v in out["post"].items()},
            "plain_ms_7x7": {k: v["plain_ms"] for k, v in out["post"].items()},
            "bound_ms_7x7": {k: v["bound_ms"] for k, v in out["post"].items()},
            "bound_ms_7x7_whole_map": {k: v["bound_ms_whole_map"]
                                       for k, v in out["post"].items()}},
        "ppn_warp_kernel": {
            "max_abs_err": out["warp"]["max_abs_err"],
            "launches_model_family_train_cli": {
                k: v["warp_launches"] for k, v in out["train_cli"].items()},
            "ms_224_b32": out["warp"]["ms"],
            "plain_ms_224_b32": out["warp"]["plain_ms"],
            "bound_ms_224_b32": out["warp"]["bound_ms"]}}}


def accuracy_tools(ctx) -> dict:
    """Phase 29: the oracle ceiling, threshold sweep (with and without TTA)
    and crowding study through their ``main`` against the JAX package's
    values (``TOOL_PINS``, ``model_points``), post launches as the code
    implies; the export of phase 28's checkpoint (whose directory it
    deletes), reloaded bitwise the f16-rounded model."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.testing import replacing_config
    from ppn_tpu_torch.train.checkpoint import load_state
    from ppn_tpu_torch.train.steps import eval_model
    from tools import (torch_crowding_study, torch_export_snapshot,
                       torch_oracle_ceiling, torch_threshold_sweep)

    overfit_ckpt = ctx.records["model_family"]["overfit_ckpt"]
    t_phase = time.perf_counter()
    out, launches = {}, {}
    # oracle ceiling: one launch over the whole set
    name, size, persons, pin = TOOL_PINS["oracle"]
    cuda_post.LAUNCHES = 0
    _, printed = quiet_call(torch_oracle_ceiling.main, [
        "--config", name, "--size", str(size), "--num-persons",
        str(persons)])
    got = printed.strip().rsplit("= ", 1)[1]
    out["oracle"] = {"pckh": got, "pin": pin}
    launches["oracle"] = [cuda_post.LAUNCHES]
    if got != pin or cuda_post.LAUNCHES != 1:
        raise AssertionError(f"oracle ceiling: {out['oracle']}")

    # the threshold sweep, without and with flip-TTA: one launch a point
    for label, extra in (("sweep", []), ("sweep_tta", ["--flip-tta"])):
        argv = ["--ckpt-dir", SNAPSHOT, "--size", str(TOOL_SWEEP_IMAGES),
                "--det", "0.10,0.15,0.20", "--nms", "0.30,0.45"] + extra

        def sweep(dtype, argv=argv, label=label):
            cuda_post.LAUNCHES = 0
            with replacing_config(train=COMPUTE_FIELDS[dtype]):
                _, printed = quiet_call(torch_threshold_sweep.main, argv)
            points = {f"{r['det']}/{r['nms']}": r["pckh_mean"] for r in (
                json.loads(line) for line in printed.splitlines()
                if line.startswith("{"))}
            launches.setdefault(label, []).append(cuda_post.LAUNCHES)
            if cuda_post.LAUNCHES != len(points) or len(points) != 6:
                raise AssertionError(f"{label}: {cuda_post.LAUNCHES} post "
                                     f"launches for {len(points)} points")
            return points

        out[label] = model_points(label, sweep, TOOL_PINS[label])

    # the crowding study: a launch per protocol, point and map set
    def crowd(dtype):
        argv = ["--config", "coco_r18_384", "--snapshot", CROWD_SNAPSHOT,
                "--protocols", "1,3,6,0", "--size", str(TOOL_CROWD_IMAGES),
                "--nms-grid", "0.3,0.45,0.6"]
        cuda_post.LAUNCHES = 0
        with tempfile.TemporaryDirectory(dir=os.path.join(
                ROOT, "build")) as d, replacing_config(
                    train=COMPUTE_FIELDS[dtype]):
            path = os.path.join(d, "study.json")
            quiet_call(torch_crowding_study.main, argv + ["--out", path])
            with open(path) as fh:
                study = json.load(fh)
        exact = {r["protocol"]: [r["collision_bound"], r["lost_person_frac"]]
                 + [p["oracle_ceiling"] for p in r["points"]]
                 for r in study["results"]}
        launches.setdefault("crowd", []).append(cuda_post.LAUNCHES)
        if exact != TOOL_PINS["crowd"]["exact"] or cuda_post.LAUNCHES != 24:
            raise AssertionError(f"crowding study: {exact} (pinned "
                                 f"{TOOL_PINS['crowd']['exact']}), "
                                 f"{cuda_post.LAUNCHES} launches")
        return {f"{r['protocol']}@{p['nms']}": p["model_pckh"]
                for r in study["results"] for p in r["points"]}

    out["crowd"] = model_points("crowd", crowd, TOOL_PINS["crowd"])

    # export: the overfit checkpoint to f16, reloaded on the card
    npz = os.path.join(overfit_ckpt, "overfit_r50_f16.npz")
    _, printed = quiet_call(torch_export_snapshot.main, [
        "--config", "mpii_r50_384", "--ckpt-dir", overfit_ckpt, "--out",
        npz])
    with np.load(npz) as z:
        beyond_f16 = sum(int((~np.isfinite(z[k])).sum()) for k in z.files)
    state = load_state(get_config("mpii_r50_384"), overfit_ckpt)
    mem = eval_model(state)
    with torch.no_grad():       # the state dict: parameters and statistics
        for t in mem.state_dict().values():
            t.copy_(t.half().float())
    reloaded = Predictor.from_npz("mpii_r50_384", npz).model
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            x = ctx.fixed["image"]
            a, b = reloaded(x), mem(x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(os.path.dirname(overfit_ckpt), ignore_errors=True)
    out["export"] = {
        "printed": printed.strip(),
        "logits_equal": bool(((a == b) | (a.isnan() & b.isnan())).all()),
        "values_beyond_f16": beyond_f16,
        "nonfinite_logits": int((~torch.isfinite(a)).sum())}
    if (not out["export"]["logits_equal"]
            or out["export"]["nonfinite_logits"]):
        raise AssertionError(f"exported snapshot: {out['export']}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return {"accuracy_tools": out, "kernels": {"ppn_post_kernel": {
        "launches_accuracy_tools": launches}}}


def stage_profilers(ctx) -> dict:
    """Phase 30: ``split_checks``, then the train, bwd and fwd splits through
    their ``main`` at ``SPLIT_ITERS``: warp launches what the train split's
    calls imply (``split_warp_launches``), none elsewhere, no post
    launch."""
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.testing import replacing_config
    from tools import torch_bwd_split, torch_fwd_split, torch_train_split

    dev, t_phase = ctx.dev, time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        checks = split_checks(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if (not checks["fwd_split_is_model"]
            or not all(c["bitwise"] and c["channels_last"]
                       for c in checks["stages_compose"].values())
            or [c["stages"] for c in checks["stages_compose"].values()] != [
                [2, 2, 2, 2], [3, 4, 6, 3], [3, 4, 6, 3]]
            or not checks["s2d_max_abs_diff"]
            <= BF16_TOL * checks["stem7_max_abs"]):
        raise AssertionError(f"stage profiler checks: {checks}")

    out, launches = {"checks": checks}, {}

    def run(label, tool, argv, fields=None):
        cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
        with replacing_config(model=fields or {}):
            rec, _ = quiet_call(tool.main, argv + [
                "--iters", str(SPLIT_ITERS), "--device", str(dev)])
        launches[label] = [cuda_post.LAUNCHES, cuda_warp.LAUNCHES]
        out[label] = rec
        return rec

    run("train_split", torch_train_split, ["--batch", str(SPLIT_TRAIN_BATCH)])
    for label, name, fields, batches in SPLIT_BWD_RUNS:
        bn = ["--batch-norm"] if label == "resnet18" else []
        rec = run(f"bwd_split_{label}", torch_bwd_split,
                  ["--config", name, "--batches", batches] + bn, fields)
        bn_layers = [row["batch_norm"]["layers"] for row in rec["batches"]
                     if "batch_norm" in row]
        if bn and bn_layers != [SPLIT_BN_LAYERS] * len(rec["batches"]):
            raise AssertionError(f"{label}: BatchNorm layers timed "
                                 f"{bn_layers}, expected {SPLIT_BN_LAYERS}")
    run("fwd_split", torch_fwd_split, ["--batch", str(SPLIT_FWD_BATCH)])

    want_warp = split_warp_launches(SPLIT_ITERS, out["train_split"])
    out["launches"] = launches
    out["warp_launches_expected"] = want_warp
    # rows whose profiler windows left kernels unrecorded (busy a lower
    # bound there, host_bound None)
    out["rows_missing_kernels"] = [
        (label, row) for label, row, busy in split_busy_rows(out)
        if busy["recorded"] < 1.0]
    if (launches["train_split"] != [0, want_warp]
            or any(v != [0, 0] for k, v in launches.items()
                   if k != "train_split")):
        raise AssertionError(f"stage profiler launches: {launches}, "
                             f"expected warp {want_warp}")
    out["seconds"] = time.perf_counter() - t_phase
    return {"stage_profilers": out, "kernels": {"ppn_warp_kernel": {
        "launches_split_tools": out["launches"]["train_split"][1]}}}
