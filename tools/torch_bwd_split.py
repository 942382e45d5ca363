"""Backward-pass stage attribution on the port: per stage (stem, s1..s4,
head), forward against forward+VJP, swept over batch sizes.

The flags, the printed lines and the record's keys are those of
tools/bwd_split.py, plus ``--device`` (``cuda`` unless asked otherwise)
and, per stage, ``device_busy_ms`` and ``host_bound``. Every stage runs in
training mode (batch-statistics BatchNorm, what the train step runs) in
the config's compute dtype:

    stem   stem conv + BN + ReLU + 3×3/2 max-pool   (B, 3, H, W) -> H/4
    s1..s4 the residual stages, split at the cumulative ``stage_sizes``
           (ResNet-18 2/2/2/2, ResNet-34 and -50 3/4/6/3)
    head   ConvBN 3×3-512 + leaky ReLU + 1×1 out    at H/32

Each stage's input is the previous stage's actual output, computed once
without grad from a seeded image: NCHW views of channels_last memory, the
layout the model gives cuDNN. Forward+VJP is ``torch.autograd.grad(y,
params + (x,), grad_outputs=y)`` over the stage's own parameters; the
stem takes parameter gradients only (the image is data: training never
computes its gradient).

Times per row: ``device_ms`` (``utils/profiling.device_latency_ms``, the
slope over back-to-back eager calls; where the host's enqueue outlasts the
device work it measures the host) and ``device_busy_ms`` (kernel time per
call over a profiler window, by ``tools/torch_predict_profile._category``);
``host_bound`` where the first exceeds the second by more than 10%.

``--batch-norm`` adds a ``batch_norm`` entry to each batch's row: every
BatchNorm layer of the model alone, each on the input the stages' forward
gave it, forward and forward+VJP (over its input, scale and bias, the
output as the cotangent) summed over the layers, timed as a stage is.

    python tools/torch_bwd_split.py [--config mpii_r18_384] \
        [--batches 32,64,128] [--stages stem,s1,s2,s3,s4,head] \
        [--fwd-only | --skip-fwd] [--batch-norm] [--out F] \
        [--device cuda|cpu]

Writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stage_names(backbone) -> list[str]:
    """stem, s1 .. s<stages>, head."""
    return ["stem"] + [f"s{i + 1}" for i in range(len(backbone.stage_sizes))
                       ] + ["head"]


def stage_modules(model, name: str):
    """The modules stage ``name`` runs (its parameters are the VJP's)."""
    if name == "stem":
        return model.backbone.stem
    if name == "head":
        return model.head
    return model.backbone.stages()[int(name[1:]) - 1]


def stage_fn(model, name: str):
    """x -> y of stage ``name``, as ``PoseProposalNet.forward`` runs it."""
    if name == "stem":
        return model.backbone.stem_pool
    if name == "head":
        return model.head
    blocks = stage_modules(model, name)

    def run(x):
        for block in blocks:
            x = block(x)
        return x

    return run


def stage_inputs(model, image):
    """{stage: its input}: ``image`` (B, H, W, 3) in the compute dtype as
    an NCHW view, then each stage's output without grad."""
    x = image.to(model.dtype).permute(0, 3, 1, 2)
    out = {}
    with torch.no_grad():
        for name in stage_names(model.backbone):
            out[name] = x
            x = stage_fn(model, name)(x)
    return out


def fwdbwd_fn(model, name: str, x):
    """() -> gradients: stage ``name``'s forward on ``x`` and its VJP with
    the output itself as the cotangent (a constant one would let the
    gradients of a linear tail go unread), over the stage's parameters
    and, except at the stem, its input."""
    f = stage_fn(model, name)
    params = tuple(stage_modules(model, name).parameters())
    if name != "stem":
        x = x.detach().requires_grad_()
        params = params + (x,)

    def run():
        y = f(x)
        return torch.autograd.grad(y, params, grad_outputs=y.detach())

    return run


def batch_norm_calls(model, image) -> list:
    """[(BatchNorm layer, its input)] in the order ``stage_inputs``' pass
    over ``image`` runs them."""
    from ppn_tpu_torch.nn.resnet import BatchNorm

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda layer, args: calls.append((layer, args[0])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        stage_inputs(model, image)
    finally:
        for h in hooks:
            h.remove()
    return calls


def batch_norm_fns(calls):
    """(forward, forward+VJP) of every layer of ``calls`` on its input, in
    turn; the VJP over the input, scale and bias, the output its
    cotangent."""
    xs = [x.detach().requires_grad_() for _, x in calls]

    def fwd():
        with torch.no_grad():
            return [layer(x) for layer, x in calls]

    def fwdbwd():
        grads = []
        for (layer, _), x in zip(calls, xs):
            y = layer(x)
            grads.append(torch.autograd.grad(
                y, (x, layer.weight, layer.bias), grad_outputs=y.detach()))
        return grads

    return fwd, fwdbwd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--batches", default="32,64,128",
                   help="comma list of batch sizes to sweep")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--stages", default="stem,s1,s2,s3,s4,head")
    only = p.add_mutually_exclusive_group()
    only.add_argument("--fwd-only", action="store_true",
                      help="skip the vjp probes (fwd rows only)")
    only.add_argument("--skip-fwd", action="store_true",
                      help="fwd+bwd rows only")
    p.add_argument("--batch-norm", action="store_true",
                   help="also time the BatchNorm layers alone")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked otherwise)")
    args = p.parse_args(argv)

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.nn.resnet import ResNet
    from ppn_tpu_torch.train.steps import create_train_state
    from ppn_tpu_torch.utils.profiling import (device_busy_ms,
                                               device_latency_ms, host_bound)
    from tools.torch_predict_profile import _category

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    model = create_train_state(cfg, device=dev).model.train()
    if not isinstance(model.backbone, ResNet):
        raise ValueError(f"the stages are a ResNet's; {cfg.model.backbone!r} "
                         f"is not one")
    H, W = cfg.model.insize
    names = args.stages.split(",")

    def timed(fn):
        ms = device_latency_ms(fn, iters=args.iters)
        busy = device_busy_ms(fn, device=dev, category=_category)
        return ms, busy, host_bound(ms, busy)

    rec = {"config": args.config, "iters": args.iters, "batches": []}
    for B in [int(b) for b in args.batches.split(",")]:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        image = torch.rand((B, H, W, 3), generator=gen, device=dev)
        inputs = stage_inputs(model, image)
        row = {"batch": B, "stages": {}}
        total_f = total_fb = 0.0
        for name in names:
            x = inputs[name]
            f = stage_fn(model, name)
            busy, bound = {}, {}
            d_f = None
            if not args.skip_fwd:
                with torch.no_grad():
                    d_f, busy["fwd"], bound["fwd"] = timed(lambda: f(x))
            if args.fwd_only:
                row["stages"][name] = {"fwd_ms": round(d_f, 3),
                                       "device_busy_ms": busy,
                                       "host_bound": bound}
                total_f += d_f
                print(f"B={B} {name}: fwd {d_f:.3f} ms", flush=True)
                continue
            d_fb, busy["fwdbwd"], bound["fwdbwd"] = timed(
                fwdbwd_fn(model, name, x))
            st = {"fwdbwd_ms": round(d_fb, 3),
                  "ms_per_img_fwdbwd": round(d_fb / B, 4)}
            if d_f is not None:
                st.update({
                    "fwd_ms": round(d_f, 3),
                    "bwd_ms": round(d_fb - d_f, 3),
                    "bwd_over_fwd": (round((d_fb - d_f) / d_f, 2)
                                     if d_f else None),
                })
                total_f += d_f
            st.update({"device_busy_ms": busy, "host_bound": bound})
            row["stages"][name] = st
            total_fb += d_fb
            print(f"B={B} {name}: fwd "
                  f"{'-' if d_f is None else f'{d_f:.3f}'} | "
                  f"fwd+bwd {d_fb:.3f} ms", flush=True)
        if args.batch_norm:
            calls = batch_norm_calls(model, image)
            fwd, fwdbwd = batch_norm_fns(calls)
            busy, bound = {}, {}
            d_f, busy["fwd"], bound["fwd"] = timed(fwd)
            d_fb, busy["fwdbwd"], bound["fwdbwd"] = timed(fwdbwd)
            row["batch_norm"] = {"layers": len(calls),
                                 "fwd_ms": round(d_f, 3),
                                 "fwdbwd_ms": round(d_fb, 3),
                                 "device_busy_ms": busy,
                                 "host_bound": bound}
            del calls, fwd, fwdbwd      # the layers' inputs, before the next B
            print(f"B={B} batch_norm ({row['batch_norm']['layers']} layers):"
                  f" fwd {d_f:.3f} | fwd+bwd {d_fb:.3f} ms", flush=True)
        if not args.skip_fwd:
            row["sum_fwd_ms"] = round(total_f, 3)
        if not args.fwd_only:
            row["sum_fwdbwd_ms"] = round(total_fb, 3)
        rec["batches"].append(row)

    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return rec


if __name__ == "__main__":
    main()
