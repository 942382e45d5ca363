"""Stage attribution for the port's train step (BASELINE config #3).

The flags, the printed lines and the record's keys are those of
tools/train_split.py, plus ``--device`` (``cuda`` unless asked otherwise),
``--out`` and, per variant, ``device_busy_ms`` and ``host_bound``. Each
variant is built from the functions ``train/steps.train_step`` itself
calls:

    full          — ``train_step(augment=True)``, the real step
    no_augment    — ``train_step(augment=False)``
    augment_only  — ``ops/augment.augment_batch`` (warp + color + flip;
                    one ``ppn_warp_kernel`` launch a call)
    encode_only   — ``ops/encode.encode_batch``
    fwd_only      — the loss forward (``train/loss.ppn_loss``), no grad
    fwdbwd_only   — ``steps.forward_backward`` on precomputed targets and
                    the gradients' global norm
    opt_ema_only  — ``steps.sgd_update`` on fixed gradients
    full_body     — ``train_step(augment=True)`` as a slope, like the
                    pieces

Every variant that changes state (the model's BatchNorm statistics, the
momentum traces, the EMA, the augmentation's generator) runs on its own
copy (``copy_state``), so each starts from the same state.

``full`` and ``no_augment`` are host-clock times of ``train_step`` calls
ending in a read of the loss; the ``device_ms`` rows are slopes over
back-to-back eager calls (``utils/profiling.device_latency_ms``: where the
host's enqueue outlasts the device work, it measures the host);
``device_busy_ms`` is the kernel time per call over a profiler window, by
``tools/torch_predict_profile._category``, and ``host_bound`` marks a row
whose time exceeds it by more than 10%.

    python tools/torch_train_split.py [--batch 32] [--config mpii_r18_384] \
        [--iters 8] [--stages all] [--out F] [--device cuda|cpu]

Writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("full", "no_augment", "augment", "encode", "fwd", "fwdbwd", "opt",
          "full_body")


def copy_state(state):
    """A ``TrainState`` that shares nothing with ``state``: the model, the
    traces, the EMA and the generator's state copied."""
    from ppn_tpu_torch.train.steps import TrainState

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return TrainState(
        model=copy.deepcopy(state.model),
        trace={n: t.clone() for n, t in state.trace.items()},
        ema=(None if state.ema is None
             else {n: t.clone() for n, t in state.ema.items()}),
        step=state.step, generator=gen)


def fwdbwd_only(cfg, model, images, targets):
    """The loss forward and every parameter's gradient on precomputed
    targets: (loss terms, gradients, their global norm)."""
    from ppn_tpu_torch.train.steps import forward_backward, grad_norm

    terms, grads = forward_backward(cfg, model, images, targets)
    return terms, grads, grad_norm(grads)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--stages", default="all",
                   help="comma list of stages to time: any of "
                        + ",".join(STAGES) + " — default all")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked otherwise)")
    args = p.parse_args(argv)
    stages = (set(STAGES) if args.stages == "all"
              else set(args.stages.split(",")))

    from ppn_tpu_torch import resolve_device
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.pipeline import collate
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.nn.resnet import ResNet
    from ppn_tpu_torch.ops.augment import augment_batch
    from ppn_tpu_torch.ops.encode import encode_batch
    from ppn_tpu_torch.train.loss import ppn_loss
    from ppn_tpu_torch.train.steps import (BATCH_KEYS, create_train_state,
                                           forward_backward, sgd_update,
                                           train_step)
    from ppn_tpu_torch.utils.profiling import (device_busy_ms,
                                               device_latency_ms, host_bound)
    from tools.torch_predict_profile import _category

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.batch != cfg.train.batch_size:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           batch_size=args.batch))
    m = cfg.model
    state = create_train_state(cfg, device=dev)
    if not isinstance(state.model.backbone, ResNet):
        raise ValueError(f"the stages are a ResNet's; {cfg.model.backbone!r} "
                         f"is not one")

    ds = SyntheticPoseDataset(cfg, size=args.batch, seed=0, cache=True)
    host = collate([ds[i] for i in range(args.batch)])
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in BATCH_KEYS}
    busy, bound = {}, {}

    def progress(msg):
        print(f"[train_split] {msg}", flush=True)

    def slope(key, body, iters):
        ms = device_latency_ms(body, iters=iters)
        busy[key] = device_busy_ms(body, device=dev, category=_category)
        bound[key] = host_bound(ms, busy[key])
        return ms

    # ---- full / no_augment: train_step on the host clock, each on a copy
    def timed_step(key, augment):
        s = copy_state(state)

        def step():
            return train_step(cfg, s, batch, augment)

        float(step()["loss_total"])          # first-call set-up
        t0 = time.perf_counter()
        for _ in range(args.iters):
            terms = step()
        float(terms["loss_total"])
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        busy[key] = device_busy_ms(step, device=dev, category=_category)
        bound[key] = host_bound(ms, busy[key])
        return ms

    t_full = t_noaug = None
    if "full" in stages:
        progress("timing full step (host loop)")
        t_full = timed_step("full", True)
        progress(f"full_step {t_full:.2f} ms")
    if "no_augment" in stages:
        progress("timing no-augment step")
        t_noaug = timed_step("no_augment", False)
        progress(f"no_augment {t_noaug:.2f} ms")

    # ---- pieces, each a slope over back-to-back calls ---------------------
    d_aug = None
    if "augment" in stages:
        progress("timing augment_only (chained)")
        gen = copy_state(state).generator
        d_aug = slope("augment_only", lambda: augment_batch(
            m, cfg.data, gen, batch, device=dev)["image"], args.iters)
        progress(f"augment_only {d_aug:.2f} ms")

    d_enc = None
    if "encode" in stages:
        d_enc = slope("encode_only", lambda: encode_batch(
            m, batch["keypoints"], batch["visible"], batch["bboxes"],
            batch["valid"]).delta, args.iters)
        progress(f"encode_only {d_enc:.2f} ms")

    targets = encode_batch(m, batch["keypoints"], batch["visible"],
                           batch["bboxes"], batch["valid"])
    image = batch["image"]

    d_fwd = d_fwdbwd = None
    if "fwd" in stages:
        progress("timing fwd_only (chained)")
        model = copy_state(state).model

        def fwd_body():
            with torch.no_grad():
                return ppn_loss(m, model(image), targets)[0]

        d_fwd = slope("fwd_only", fwd_body, args.iters)
        progress(f"fwd_only {d_fwd:.2f} ms")
    if "fwdbwd" in stages:
        progress("timing fwdbwd_only")
        model = copy_state(state).model

        def fwdbwd_body():
            terms, _, norm = fwdbwd_only(cfg, model, image, targets)
            return terms["loss_total"] + norm

        d_fwdbwd = slope("fwdbwd_only", fwdbwd_body, max(4, args.iters // 2))
        progress(f"fwdbwd_only {d_fwdbwd:.2f} ms")

    # ---- optimizer + EMA alone, on fixed gradients -----------------------
    d_opt = None
    if "opt" in stages:
        s = copy_state(state)
        _, grads = forward_backward(cfg, copy_state(state).model, image,
                                    targets)

        def opt_body():
            sgd_update(cfg, s, grads)
            return s.model.backbone.stem.conv.weight

        d_opt = slope("opt_ema_only", opt_body, args.iters)
        progress(f"opt_ema_only {d_opt:.2f} ms")

    # ---- the whole step as one body, timed like the pieces ----------------
    d_full = None
    if "full_body" in stages:
        progress("timing full_body")
        s = copy_state(state)
        d_full = slope("full_body", lambda: train_step(
            cfg, s, batch, True)["loss_total"], max(4, args.iters // 2))
        progress(f"full_body {d_full:.2f} ms")

    r3 = lambda v: None if v is None else round(v, 3)  # noqa: E731
    out = {
        "config": cfg.name, "batch": args.batch,
        "backend": dev.type,
        "full_step_ms": r3(t_full),
        "full_step_images_per_sec": (
            round(args.batch / t_full * 1e3, 1) if t_full else None),
        "no_augment_step_ms": r3(t_noaug),
        "device_ms": {
            "augment_only": r3(d_aug),
            "encode_only": r3(d_enc),
            "fwd_only": r3(d_fwd),
            "fwdbwd_only": r3(d_fwdbwd),
            "opt_ema_only": r3(d_opt),
            "full_body": r3(d_full),
        },
        "device_images_per_sec": round(args.batch / d_full * 1e3, 1)
        if d_full else None,
        "residual_ms_optimizer_ema_bookkeeping": round(
            t_full - d_aug - d_enc - d_fwdbwd, 3)
        if None not in (t_full, d_aug, d_enc, d_fwdbwd) else None,
        "note": "full/no_augment are host-clock train_step calls; device_ms "
                "rows are slopes over back-to-back eager calls (the host's "
                "enqueue where it outlasts the device work); device_busy_ms "
                "is kernel time per call from a profiler window, and "
                "host_bound marks a row over it by more than 10%",
        "device_busy_ms": busy,
        "host_bound": bound,
    }
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
