"""Phases 1-4 and 17: the device, the build, the three hand-written
kernels against their plain versions on the card, and their times beside
their bounds."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from chip.context import ULP_LIMIT, compare, log
from chip.timing import graph_ms, time_ms

# H100 SXM data-sheet HBM rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
# phase 4: BatchNorm maps at 384² (batch, channels, side) with the
# activation each folds in: ResNet-18's (the stem, the stages, the head) at
# B=8, then the benchmark's grids: ResNet-18's stem at B=128, ResNet-50's
# stem, its first stage's wide map and its last stage's map at B=64, and
# HRNet-W32's maps at B=128 that no ResNet has: the stride-4 branch (C=32
# over 96², with and without its ReLU), the exchange units' maps without
# one, the other branches and the head's widest map at stride 32
BN_CASES = ((8, 64, 192, "relu"), (8, 64, 96, "relu"), (8, 64, 96, None),
            (8, 128, 48, "relu"), (8, 256, 24, None), (8, 512, 12, "relu"),
            (8, 512, 12, "leaky_relu"), (128, 64, 192, "relu"),
            (64, 64, 192, "relu"), (64, 256, 96, None), (64, 2048, 12, None),
            (128, 32, 96, "relu"), (128, 32, 96, None), (128, 32, 48, None),
            (128, 32, 12, None), (128, 64, 48, None), (128, 64, 24, "relu"),
            (128, 128, 24, None), (128, 128, 12, None),
            (128, 256, 12, "relu"), (128, 1024, 12, None))
BN_EPS, BN_MOMENTUM = 1e-5, 0.9
# (angle, scale, tx, flip): the warp cases of tests/test_pallas_warp.py
WARP_CASES = [(0.0, 1.0, 0.0, False), (0.3, 1.1, 12.0, False),
              (-0.5, 0.8, -7.0, False), (0.7, 1.25, 3.0, True),
              (0.69, 3.9, 50.0, False), (-0.69, 0.26, -120.0, True)]


def whole_map_bound_ms(cfg, B: int) -> float:
    """ppn_post_kernel's bound if it read the whole f32 map: the map read
    once and the People fields written once, over the HBM rate."""
    from ppn_tpu_torch.ops.cuda_post import output_bytes

    H, W = cfg.outsize
    nbytes = B * (H * W * cfg.num_channels * 4 + output_bytes(cfg))
    return 1e3 * nbytes / HBM_BYTES_PER_S


def kernel_bound_ms(cfg, fm: torch.Tensor) -> float:
    """Least time for ppn_post_kernel's work on this map: the bytes this
    input needs (``cuda_post.needed_bytes``: the proposal channels, the limb
    logits whose destination keeps a score, the outputs) over the HBM rate.
    Its operation count depends on the data through NMS and is not
    counted, so the bound is by bytes."""
    from ppn_tpu_torch.ops.cuda_post import needed_bytes

    return 1e3 * needed_bytes(cfg, fm) / HBM_BYTES_PER_S


def post_stage_us(cfg, fm: torch.Tensor, reps: int) -> tuple[dict, float]:
    """Mean µs of each ppn_post_kernel stage over the CTAs of `reps`
    launches, from the kernel's %globaltimer stamps; and the mean span of a
    launch, from the first CTA's entry to the last CTA's end (µs)."""
    from ppn_tpu_torch.ops import cuda_post

    clocks = torch.zeros((fm.shape[0], len(cuda_post.STAGES) + 1),
                         dtype=torch.int64, device=fm.device)
    sums, span = dict.fromkeys(cuda_post.STAGES, 0.0), 0.0
    for _ in range(reps):
        cuda_post.postprocess_batch_cuda(cfg, fm, stage_clocks=clocks)
        torch.cuda.synchronize()
        for k, v in cuda_post.stage_us(clocks).items():
            sums[k] += v / reps
        span += float(clocks[:, -1].max() - clocks[:, 0].min()) / 1e3 / reps
    return sums, span


def warp_bound_ms(images: torch.Tensor) -> float:
    """Least time for ppn_warp_kernel's work: each input pixel read once and
    each output pixel written once (the 24 bytes of matrices per image
    besides), over the HBM rate. Its ~60 f32 operations per pixel and
    channel are far below the card's f32 rate, so the bound is by bytes."""
    B = images.shape[0]
    nbytes = 2 * images.numel() * images.element_size() + B * 24
    return 1e3 * nbytes / HBM_BYTES_PER_S


def case_matrices(H: int, W: int, B: int, dev) -> torch.Tensor:
    """(B, 2, 3) matrices of the first B unit-test cases about the centre
    of an H×W image."""
    from ppn_tpu_torch.ops.image import make_affine

    c = torch.tensor([W / 2.0, H / 2.0], device=dev)
    a, s, t, f = zip(*WARP_CASES[:B])
    return make_affine(
        c, c, torch.tensor(a, device=dev), torch.tensor(s, device=dev),
        torch.tensor([[x, -x] for x in t], device=dev),
        torch.tensor(f, device=dev))[0]


def warp_matrices(cfg, B: int, dev, seed: int) -> torch.Tensor:
    """(B, 2, 3) matrices: the six test cases first, then draws of
    ``sample_params`` on the card for random person boxes."""
    from ppn_tpu_torch.ops.augment import sample_params

    H, W = cfg.model.insize
    cases = case_matrices(H, W, len(WARP_CASES), dev)
    if B <= len(WARP_CASES):
        return cases[:B]
    rng = np.random.default_rng(seed)
    P = 4
    boxes = np.concatenate([rng.uniform(0, W, (B, P, 2)),
                            rng.uniform(8, W / 2, (B, P, 2))], -1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    drawn = sample_params(
        cfg.model, cfg.data, gen,
        torch.tensor(boxes, dtype=torch.float32, device=dev),
        torch.from_numpy(rng.random((B, P)) < 0.7).to(dev)).bwd
    return torch.cat([cases, drawn[len(WARP_CASES):]])


def bn_case(B: int, C: int, side: int, dtype, dev, seed: int = 0):
    """A channels_last (B, C, side, side) map with channels of their own
    mean and spread, scale and bias, and an upstream gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    shift, spread = randn(C), randn(C).abs() + 0.5
    x = (randn(B, side, side, C) * spread + shift).to(dtype).permute(
        0, 3, 1, 2)
    dy = randn(B, side, side, C).to(dtype).permute(0, 3, 1, 2)
    return x, randn(C).abs() + 0.5, 0.1 * randn(C), dy


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    """(the most ulps of ``want``'s dtype between the two, the share of
    values that differ)."""
    d = (got.float() - want.float()).abs()
    tiny = torch.finfo(want.dtype).tiny
    _, e = torch.frexp(want.float().abs().clamp_min(tiny))
    bits = 8 if want.dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(d), e - bits)
    return int((d / ulp).ceil().max()), float((d > 0).float().mean())


def post_time(m, fm: torch.Tensor) -> dict:
    """ppn_post_kernel's time on ``fm`` (a CUDA graph of 50 launches)
    beside its plain version's (5 calls) and its two bounds."""
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    call = functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
    return {"ms": graph_ms(call, 50),
            "plain_ms": time_ms(lambda: postprocess_batch_plain(m, fm), 5),
            "bound_ms": kernel_bound_ms(m, fm),
            "bound_ms_whole_map": whole_map_bound_ms(m, fm.shape[0])}


def check_post(m, B: int, kind: str, tag: str) -> tuple[int, float]:
    """ppn_post_kernel against ``postprocess_batch_plain`` on the seeded
    ``kind`` map of model config ``m`` at batch ``B``: every decision field
    bitwise, the floats within ULP_LIMIT. Returns the ulps and the largest
    absolute error."""
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import feature_map_case

    fm = torch.from_numpy(feature_map_case(m, B, seed=B, kind=kind)).cuda()
    got = cuda_post.postprocess_batch_cuda(m, fm)
    want = postprocess_batch_plain(m, fm)
    torch.cuda.synchronize()
    equal, ulp, err = compare(got, want)
    log(f"{tag} B={B} {kind}: decisions_equal={equal} max_ulp={ulp} "
        f"max_abs_err={err:.3g} persons={int(want.valid.sum())}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError(f"kernel disagrees: {tag} B={B} {kind}")
    return ulp, err


def check_nan_window(m, tag: str) -> None:
    """ppn_post_kernel on ``testing.nan_window_case``: one NaN limb logit
    beside its window's winner, so slot 0's destination has no winner
    (cell (0, 0), score 0), as in the plain version."""
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import nan_window_case

    fm = torch.from_numpy(nan_window_case(m)).cuda()
    got = cuda_post.postprocess_batch_cuda(m, fm)
    want = postprocess_batch_plain(m, fm)
    torch.cuda.synchronize()
    equal, ulp, _ = compare(got, want)
    d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
    cell, score = got.kp_cell[0, 0, d].tolist(), float(got.kp_score[0, 0, d])
    log(f"{tag} NaN window case: decisions_equal={equal} max_ulp={ulp}; "
        f"slot 0 class {d}: cell {cell} score {score}")
    if not equal or ulp > ULP_LIMIT or cell != [0, 0] or score != 0.0:
        raise AssertionError(f"kernel disagrees: {tag} NaN window case")


def check_warp(images: torch.Tensor, mats: torch.Tensor,
               tag: str) -> tuple[float, int]:
    """ppn_warp_kernel against ``affine_warp_separable_plain``, bitwise,
    on ``images`` in bf16 and in f32. Returns the largest difference and
    the values compared."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.ops.image import affine_warp_separable_plain

    worst, values = 0.0, 0
    for dt in (torch.bfloat16, torch.float32):
        x = images.to(dt)
        got = cuda_warp.affine_warp_cuda(x, mats)
        want = affine_warp_separable_plain(x, mats)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        n_diff = int((d > 0).sum())
        worst, values = max(worst, float(d.max())), values + d.numel()
        log(f"{tag} {str(dt)[6:]}: differing values {n_diff} of "
            f"{d.numel()}, max_abs_err {float(d.max()):.3g}")
        if n_diff:
            raise AssertionError(f"ppn_warp_kernel differs from its plain "
                                 f"version: {tag} {dt}")
    return worst, values


def device(ctx) -> dict:
    """Phase 1: the card's ``nvidia-smi`` name and power limit, torch's
    and CUDA's versions; TF32 off for matmuls and cuDNN convs."""
    log(f"[device] {ctx.card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {}


def build(ctx) -> dict:
    """Phase 2: the kernel sources (csrc/post.cu, warp.cu, batch_norm.cu)
    compiled for sm_90a, one nvcc each, in parallel, and beside them the
    native JPEG pool (native/loader.cc) with g++ against the imported
    Pillow's libjpeg-turbo (none fails the run: there is no PIL fallback)."""
    from concurrent.futures import ThreadPoolExecutor

    from ppn_tpu_torch.native import loader as native_loader
    from ppn_tpu_torch.ops import cuda_bn, cuda_build, cuda_post, cuda_warp

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # g++ beside the nvcc processes
        native_lib = pool.submit(native_loader.load)
        reports = cuda_build.build([cuda_post.SOURCE, cuda_warp.SOURCE,
                                    cuda_bn.SOURCE], force=True)
        native_lib.result()
    log(f"[build] ppn_post_kernel, ppn_warp_kernel and ppn_bn_* built in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc), the native JPEG "
        f"pool beside them ({native_loader.LIB.name} linking "
        f"{native_loader.libjpeg()})")
    for source, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {source}: {line.strip()}")
    return {}


def post_kernel(ctx) -> dict:
    """Phase 3: ``ppn_post_kernel`` against its plain version at every
    batch and threshold set the main paths and phase 26's suite give it
    (tiny_test; mpii_r18_384 at B=1 to 128; coco_r18_384 at B=32; the
    crowded config at B=128) on the seeded kinds, the ``empty`` and
    ``chain`` edge maps, B=133 (more CTAs than SMs) and the NaN window case:
    decisions bitwise, floats within 4 ulps."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.testing import KINDS

    cases = [(name, B, kind) for name, B in (
        ("tiny_test", 3), ("mpii_r18_384", 1), ("mpii_r18_384", 2),
        ("mpii_r18_384", 4), ("mpii_r18_384", 8), ("mpii_r18_384", 16),
        ("mpii_r18_384", 32), ("mpii_r18_384", 128), ("coco_r18_384", 32),
        ("coco_r18_384_crowded", 128))
        for kind in KINDS]
    cases += [("mpii_r18_384", 8, "empty"), ("mpii_r18_384", 8, "chain"),
              ("coco_r18_384_crowded", 8, "chain"),
              ("mpii_r18_384", 133, "normal")]
    worst_ulp, worst_err = 0, 0.0
    for name, B, kind in cases:
        ulp, err = check_post(get_config(name).model, B, kind,
                              f"[kernel] {name}")
        worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
    for name in ("tiny_test", "mpii_r18_384", "coco_r18_384_crowded"):
        check_nan_window(get_config(name).model, f"[kernel] {name}")
    return {"kernels": {"ppn_post_kernel": {"max_ulp": worst_ulp,
                                            "max_abs_err": worst_err}}}


def warp_kernel(ctx) -> dict:
    """Phase 4: ``ppn_warp_kernel`` bitwise its plain version in bf16 and
    f32: 384² at B=32 (drawn matrices) and B=6 (the unit tests' six),
    tiny_test's 64² likewise, 64×97 (no tile divides it) at C=1, 3, 4 and
    384² at B=1; then the BatchNorm kernels (``batch_norm_checks``)."""
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    dev, cache, mpii, tiny = ctx.dev, ctx.cache, ctx.mpii, ctx.tiny
    tiny_img = torch.from_numpy(np.stack(
        [SyntheticPoseDataset(tiny, size=8, seed=3)[i]["image"]
         for i in range(8)])).to(dev)
    warp_cases = []
    for cfg_w, images in ((mpii, cache.data["image"][:32].float() / 255.0),
                          (tiny, tiny_img)):
        for B in (images.shape[0], len(WARP_CASES)):
            warp_cases.append((f"{cfg_w.name} B={B}", images[:B],
                               warp_matrices(cfg_w, B, dev, seed=B)))
    rng = np.random.default_rng(4)
    for H, W, C, B in ((64, 97, 3, 6), (64, 97, 1, 6), (64, 97, 4, 6),
                       (384, 384, 3, 1)):   # widths no tile divides, C, B
        pixels = rng.random((B, H, W, C), np.float32)
        warp_cases.append((f"edge {H}x{W}x{C} B={B}",
                           torch.from_numpy(pixels).to(dev),
                           case_matrices(H, W, B, dev)))
    warp_err, warp_pixels = 0.0, 0
    for label, images, mats in warp_cases:
        err, values = check_warp(images, mats, f"[warp] {label}")
        warp_err, warp_pixels = max(warp_err, err), warp_pixels + values
    return {"kernels": {
        "ppn_warp_kernel": {"max_abs_err": warp_err,
                            "values_compared": warp_pixels},
        "ppn_bn_*": batch_norm_checks(dev, ctx.card)}}


def batch_norm_checks(dev, card: str) -> dict:
    """Phase 4, BatchNorm: ``ppn_bn_*`` against their plain version on
    ``BN_CASES``, the activation each folds in included: the sums within
    f32 rounding, and given the kernels' sums ``y``, ``dx`` and the
    parameter gradients within one ulp; then timed at the stem's B=128 map
    beside the bytes bound, PyTorch's SyncBatchNorm primitives with a
    separate ReLU, and the plain version. Returns the kernel table's
    fields."""
    from ppn_tpu_torch.ops import cuda_bn

    worst = {"sums": 0.0, "grad_sums": 0.0, "y": (0, 0.0), "dx": (0, 0.0),
             "params": (0, 0.0)}
    for B, C, side, act in BN_CASES:
        for dt in (torch.bfloat16, torch.float32):
            x, w, b, dy = bn_case(B, C, side, dt, dev)
            rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
            y, sums = cuda_bn.forward_cuda(x, w, b, rm, rv, BN_EPS,
                                           BN_MOMENTUM, act)
            dx, dw, db, gsums = cuda_bn.backward_cuda(dy, x, sums, w, b,
                                                      BN_EPS, act)
            xf = x.float()
            rel = ((sums - cuda_bn.stats_plain(xf)).abs()
                   / cuda_bn.stats_plain(xf.abs()))
            mean = (sums[:C] / sums[2 * C])[:, None, None]
            dyf = dy.float().abs()
            scale = torch.cat([dyf.sum((0, 2, 3)),
                               (dyf * (xf - mean).abs()).sum((0, 2, 3))])
            grel = (gsums - cuda_bn.grad_sums_plain(
                dy, x, sums, w, b, BN_EPS, act)).abs() / scale
            want = cuda_bn.apply_plain(
                xf, sums, w, b, torch.zeros(C, device=dev),
                torch.ones(C, device=dev), BN_EPS, BN_MOMENTUM, dt, act)
            pdx, pdw, pdb = cuda_bn.backward_plain(dy, x, sums, gsums, w, b,
                                                   BN_EPS, act)
            found = {"sums": float(rel.max()), "grad_sums": float(grel.max()),
                     "y": ulps_apart(y, want), "dx": ulps_apart(dx, pdx),
                     "params": ulps_apart(torch.cat([dw, db]).to(dt),
                                          torch.cat([pdw, pdb]).to(dt))}
            log(f"[bn] B={B} C={C} {side}x{side} {str(dt)[6:]} act={act}: "
                f"sums rel {found['sums']:.2e}, gradient sums rel "
                f"{found['grad_sums']:.2e}; given the kernels' sums, (ulps, "
                f"share differing): y {found['y']}, dx {found['dx']}, "
                f"dweight+dbias {found['params']}")
            for k, v in found.items():
                worst[k] = max(worst[k], v)
            if (found["sums"] > 1e-5 or found["grad_sums"] > 1e-5
                    or max(found["y"][0], found["dx"][0],
                           found["params"][0]) > 1):
                raise AssertionError(f"ppn_bn_* differs from its plain "
                                     f"version: B={B} C={C} {side} {dt} "
                                     f"{act}")
            del x, dy, y, dx, xf, want, pdx
        torch.cuda.empty_cache()
    x, w, b, dy = bn_case(128, 64, 192, torch.bfloat16, dev)
    rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
    _, sums = cuda_bn.forward_cuda(x, w, b, rm, rv, BN_EPS, BN_MOMENTUM,
                                   "relu")

    def fwd():
        cuda_bn.forward_cuda(x, w, b, rm, rv, BN_EPS, BN_MOMENTUM, "relu")

    def bwd():
        cuda_bn.backward_cuda(dy, x, sums, w, b, BN_EPS, "relu")

    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()

    def layer(fn):
        def run():
            xr = x.detach().requires_grad_()
            y = fn(xr, wg, bg, rm, rv, BN_EPS, BN_MOMENTUM, torch.bfloat16,
                   "relu")
            torch.autograd.grad(y, (xr, wg, bg), dy)
        return run

    # PyTorch's SyncBatchNorm primitives (Welford statistics, channels_last
    # kernels) as its SyncBatchNorm calls them on one rank, then the ReLU
    # and its backward as separate passes
    count = torch.full((1,), float(x.numel() // 64), device=dev)
    lib = {}

    def lib_fwd():
        m, s = torch.batch_norm_stats(x, BN_EPS)
        m, s = torch.batch_norm_gather_stats_with_counts(
            x, m[None], s[None], rm, rv, 1 - BN_MOMENTUM, BN_EPS, count)
        lib.update(mean=m, invstd=s,
                   y=torch.relu(torch.batch_norm_elemt(x, w, b, m, s,
                                                       BN_EPS)))

    def lib_bwd():
        g = torch.ops.aten.threshold_backward(dy, lib["y"], 0)
        sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(
            g, x, lib["mean"], lib["invstd"], w, True, True, True)
        torch.batch_norm_backward_elemt(g, x, lib["mean"], lib["invstd"], w,
                                        sdy, sdyx, count.int())

    f_ms, b_ms = graph_ms(fwd, 20), graph_ms(bwd, 20)
    lib_fwd()
    lib_f_ms, lib_b_ms = graph_ms(lib_fwd, 20), graph_ms(lib_bwd, 20)
    layer_ms = time_ms(layer(cuda_bn.batch_norm_train), 20)
    plain_ms = time_ms(layer(cuda_bn.batch_norm_train_plain), 3)
    nbytes = x.numel() * x.element_size()
    f_bound, b_bound = (1e3 * k * nbytes / HBM_BYTES_PER_S for k in (3, 5))
    log(f"[time] BatchNorm at the stem's map, B=128 64x192x192 bf16 + ReLU: "
        f"ppn_bn_* forward {f_ms:.4f} ms (bound {f_bound:.4f}: x read twice, "
        f"y written), backward {b_ms:.4f} ms (bound {b_bound:.4f}: dy and x "
        f"read twice, dx written), CUDA graphs of 20 calls; PyTorch's "
        f"SyncBatchNorm primitives with a separate ReLU forward "
        f"{lib_f_ms:.4f} ms, backward {lib_b_ms:.4f} ms, the same way; the "
        f"layer's forward+backward through autograd back to back "
        f"{layer_ms:.4f} ms; plain {plain_ms:.3f} ms | {card}")
    return {"worst": worst, "ms": f_ms + b_ms, "ms_forward": f_ms,
            "ms_backward": b_ms, "bound_ms": f_bound + b_bound,
            "library_ms": lib_f_ms + lib_b_ms, "plain_ms": plain_ms,
            "ms_layer_eager": layer_ms}


def warp_times(ctx) -> dict:
    """Phase 17: ``ppn_warp_kernel`` at B=32 bf16 timed beside its plain
    version and its bound; at B=128 (the suite's configs 3b and 3c) bitwise
    its plain version, and timed likewise."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.ops.image import affine_warp_separable_plain

    cache, mpii, dev = ctx.cache, ctx.mpii, ctx.dev
    xw = cache.data["image"][:32].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    mw = warp_matrices(mpii, 32, dev, seed=32)
    wcall = functools.partial(cuda_warp.affine_warp_cuda, xw, mw)
    w_ms, w_eager_ms = graph_ms(wcall, 50), time_ms(wcall, 50)
    wp_ms = time_ms(lambda: affine_warp_separable_plain(xw, mw), 5)
    x128 = cache.data["image"][:128].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    m128 = warp_matrices(mpii, 128, dev, seed=128)
    got = cuda_warp.affine_warp_cuda(x128, m128)
    if not torch.equal(got, affine_warp_separable_plain(x128, m128)):
        raise AssertionError("ppn_warp_kernel differs from its plain version "
                             "at B=128")
    return {"kernels": {"ppn_warp_kernel": {
        "ms": w_ms, "plain_ms": wp_ms, "bound_ms": warp_bound_ms(xw),
        "ms_eager": w_eager_ms, "ms_b128": graph_ms(functools.partial(
            cuda_warp.affine_warp_cuda, x128, m128), 50),
        "plain_ms_b128": time_ms(
            lambda: affine_warp_separable_plain(x128, m128), 5),
        "bound_ms_b128": warp_bound_ms(x128)}}}
