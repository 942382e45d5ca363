"""Forward-pass stage attribution on the port, plus the space-to-depth
stem A/B.

The flags, the printed lines and the record's keys are those of
tools/fwd_split.py, plus ``--device`` (``cuda`` unless asked otherwise)
and ``device_busy_ms`` and ``host_bound`` per variant. The model runs in
eval mode (running-statistics BatchNorm, the inference path) in the
config's compute dtype on seeded f32 NHWC images in [0, 1]:

    full    ``model(img)``
    ingest  normalize, cast, NCHW view + stem conv + ReLU + max-pool
    blocks  the residual stages
    head    ConvBN 3×3 + leaky ReLU + 1×1 out, NHWC f32

``ingest`` ∘ ``blocks`` ∘ ``head`` runs exactly ``model(img)``'s calls.
The A/B times the stem alone two ways with the same weights: the 7×7/s2
conv over 3 channels, and ``s2d_weights``' exact rewrite as a 4×4/s1 conv
over the 12 channels of a 2×2 space-to-depth input (147 taps in 192
slots), each followed by the eval BatchNorm affine, ReLU and the pool;
``s2d_max_abs_diff`` is their largest difference.

Times per row: ``device_ms`` (``utils/profiling.device_latency_ms``, the
slope over back-to-back eager calls; where the host's enqueue outlasts the
device work it measures the host) and ``device_busy_ms`` (kernel time per
call over a profiler window, by ``tools/torch_predict_profile._category``);
``host_bound`` where the first exceeds the second by more than 10%.

    python tools/torch_fwd_split.py [--batch 128] [--config mpii_r18_384] \
        [--iters 16] [--out F] [--device cuda|cpu]

Writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def s2d_weights(w7: np.ndarray) -> np.ndarray:
    """Embed a (7,7,3,Co) stride-2 kernel into a (4,4,12,Co) stride-1 kernel
    over block-2 space-to-depth input (channel order (a*2+b)*C+c for input
    pixel (2u+a, 2v+b, c)). SAME padding for k=7/s=2 on an even size is
    (2,3), so output o(i,j) sums taps at original rows 2i+ky-2; in s2d
    coords that is rows i-1..i+2 => explicit padding (1,2). Row mapping:
    ku = (ky-2)//2 + 1, a = ky % 2 (unique pairs; slot (3,1) stays zero)."""
    C = w7.shape[2]
    co = w7.shape[3]
    w4 = np.zeros((4, 4, 4 * C, co), w7.dtype)
    for ky in range(7):
        ku, a = (ky - 2) // 2 + 1, ky % 2
        for kx in range(7):
            kv, b = (kx - 2) // 2 + 1, kx % 2
            w4[ku, kv, (a * 2 + b) * C:(a * 2 + b) * C + C] = w7[ky, kx]
    return w4


def ingest(model, img):
    """Normalize, cast, NCHW view, stem conv + BN + ReLU + max-pool: the
    first calls of ``PoseProposalNet.forward`` on f32 images."""
    x = (img - model.mean.to(img.dtype)) / model.std.to(img.dtype)
    return model.backbone.stem_pool(x.to(model.dtype).permute(0, 3, 1, 2))


def blocks(model, x):
    for block in model.backbone.blocks:
        x = block(x)
    return x


def head(model, x):
    """The head and the NHWC f32 map, as ``PoseProposalNet.forward``."""
    return model.head(x).permute(0, 2, 3, 1).to(torch.float32).contiguous()


def stem_variants(model) -> dict:
    """{name: images -> output} of the stem A/B on ``model``'s stem weights
    and running statistics, in its compute dtype: ``norm_only``,
    ``conv7_only`` (normalize + the 7×7/s2 conv), ``stem7`` and ``s2d``
    (each conv then the eval affine, ReLU and the 3×3/2 max-pool)."""
    from ppn_tpu_torch.nn.resnet import pad_same

    dt, stem = model.dtype, model.backbone.stem
    w = stem.conv.weight.detach()
    w7 = w.to(dt)
    # HWIO numpy as the original takes it, OIHW at the call
    w4 = torch.from_numpy(s2d_weights(
        w.permute(2, 3, 1, 0).cpu().numpy())).permute(3, 2, 0, 1).to(w.device,
                                                                     dt)
    bn = stem.bn
    g = (bn.weight / torch.sqrt(bn.running_var + 1e-5)).to(dt)
    beta = (bn.bias - bn.running_mean * g.to(torch.float32)).to(dt)
    g, beta = g[:, None, None], beta[:, None, None]
    mean, std = model.mean, model.std

    def affine_relu_pool(y):
        y = F.relu(y * g + beta)
        y, pad = pad_same(y, 3, 2, value=float("-inf"))
        return F.max_pool2d(y, 3, 2, padding=pad)

    def norm(x):
        return ((x - mean) / std).to(dt)

    def conv7_only(x):
        x, pad = pad_same(norm(x).permute(0, 3, 1, 2), 7, 2)
        return F.conv2d(x, w7, stride=2, padding=pad)

    def stem_s2d(x):
        x = norm(x)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        x = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2))
        return affine_relu_pool(F.conv2d(x, w4))

    return {"norm_only": norm, "conv7_only": conv7_only,
            "stem7": lambda x: affine_relu_pool(conv7_only(x)),
            "s2d": stem_s2d}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--out", default=None, help="also write the JSON here")
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
    model = create_train_state(cfg, seed=0, device=dev).model.eval()
    if not isinstance(model.backbone, ResNet):
        raise ValueError(f"the stages are a ResNet's; {cfg.model.backbone!r} "
                         f"is not one")
    B = args.batch
    img = torch.from_numpy(np.random.default_rng(0).random(
        (B, *cfg.model.insize, 3), np.float32)).to(dev)

    res = {"batch": B}
    busy, bound = {}, {}

    def timed(name, fn, x):
        ms = device_latency_ms(fn, x, iters=args.iters)
        busy[name] = device_busy_ms(fn, x, device=dev, category=_category)
        bound[name] = host_bound(ms, busy[name])
        res[f"{name}_ms"] = round(ms, 3)

    with torch.no_grad():
        x1 = ingest(model, img)
        x2 = blocks(model, x1)
        for name, fn, inp in (("full", model, img),
                              ("ingest", lambda x: ingest(model, x), img),
                              ("blocks", lambda x: blocks(model, x), x1),
                              ("head", lambda x: head(model, x), x2)):
            timed(name, fn, inp)
            print(f"{name}: {res[f'{name}_ms']} ms @B={B}", flush=True)

        # ---- space-to-depth stem A/B (same weights) ----------------------
        stems = stem_variants(model)
        a, b = stems["stem7"](img), stems["s2d"](img)
        diff = float((a.float() - b.float()).abs().max())
        res["s2d_max_abs_diff"] = diff
        for nm in ("norm_only", "conv7_only", "stem7", "s2d"):
            timed(nm, stems[nm], img)
    print(f"norm {res['norm_only_ms']} | norm+conv7 {res['conv7_only_ms']} "
          f"| stem 7x7/s2 C=3: {res['stem7_ms']} ms | "
          f"s2d 4x4/s1 C=12: {res['s2d_ms']} ms | "
          f"max|diff|={diff:.3e}", flush=True)
    res.update({"device_busy_ms": busy, "host_bound": bound})
    print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
