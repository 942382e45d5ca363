"""Phases 5-12: the inference path on the committed snapshots — PCKh,
B=128 predict, flip-TTA, the OKS evaluation and its CLI, the CLIs on
files, B=1 latency, the server and the video stream."""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from chip.context import (COCO_SNAPSHOT, CROWD_SNAPSHOT, FLOATS, ROOT,
                          SNAPSHOT, ULP_LIMIT, VIDEO_FRAMES, compare,
                          frame_vs_plain, log, quiet_call, scratch_dir,
                          train_cli, video_cli)
from chip.kernels import post_stage_us, post_time
from chip.timing import (event_times, events_ms, graph_ms, host_us,
                         percentiles_ms, time_ms)

PINNED_PCKH, PINNED_JOINTS = 0.9921, 378
# flip-TTA on the same protocol: the JAX package's value on its CPU
# (train/steps.make_forward(flip_tta=True) through eval/runner.evaluate_pckh)
PINNED_TTA_PCKH = 0.98942
LATENCY_CALLS = 200
# COCO OKS AP of the JAX package on its CPU (train/steps.make_forward through
# eval/runner.evaluate_oks), 16 held-out synthetic images at B=8:
# label -> (config, snapshot, persons, det/nms, flip-TTA, AP, GT persons)
OKS_PINS = {
    "coco": ("coco_r18_384", COCO_SNAPSHOT, 2, (0.02, 0.6), False,
             0.945134, 32),
    "coco_tta": ("coco_r18_384", COCO_SNAPSHOT, 2, (0.02, 0.6), True,
                 0.972408, 32),
    "crowd": ("coco_r18_384_crowded", CROWD_SNAPSHOT, 5, None, False,
              0.862841, 80),
}
OKS_TOLERANCE = 5e-3   # about one match flipped at one of the ten OKS
                       # thresholds among 32 GT: bf16 cuDNN logits against
                       # the CPU's
# The JAX package's values on its CPU (train/steps.make_forward through
# eval/runner.evaluate_pckh / evaluate_oks) on the 16 held-out protocol
# images written as files by ppn_tpu_torch/testing.py, read back through
# ppn_tpu/data/{mpii,coco}.py at native_jpeg=True (the JPEGs are 384², so
# the native decode and PIL's give the same PCKh there), at B=8:
# label -> (config, snapshot, --data, file set, metric, det/nms, value,
#           the count key, its value, tolerance)
FILE_PINS = {
    "mpii_png": ("mpii_r18_384", SNAPSHOT, "mpii", "mpii_png", "pckh",
                 (0.02, 0.45), 0.976190, "pckh/num_joints", 378, 3e-3),
    "mpii_jpg": ("mpii_r18_384", SNAPSHOT, "mpii", "mpii_jpg", "pckh",
                 (0.02, 0.45), 0.965608, "pckh/num_joints", 378, 3e-3),
    "coco_png": ("coco_r18_384", COCO_SNAPSHOT, "coco", "coco_png", "oks",
                 (0.02, 0.6), 0.945134, "oks/num_gt", 32, OKS_TOLERANCE),
}
# where those values were taken: PIL, its libjpeg-turbo, and the sha256 of
# the 16 images of each set in file order
FILE_SET_ORIGIN = {
    "pil": "12.1.0", "libjpeg_turbo": "3.1.3",
    "mpii_jpg": ("5776783285796dddcc336b95f88ae3a0"
                 "63357723851be6541a3ab08e6f992c05"),
    "mpii_png": ("92622285a2ea5d128164f5362e85e063"
                 "5d8c299a88b17a2ce0b1dc69e207fcb4")}
FILE_TRAIN_IMAGES, FILE_TRAIN_STEPS, FILE_VIDEO_FRAMES = 64, 10, 32


def sha256_of(directory: str) -> str:
    """One sha256 over the bytes of a directory's files in name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def write_file_sets(d: str) -> dict:
    """Phase 9's dataset trees under ``d``: the 16 held-out protocol images
    (seed 10 000, two persons) as MPII PNGs, MPII JPEGs and COCO PNGs, each
    with the same list as its train and validation annotations; and an
    MPII JPEG tree of 64 training images (seed 0) with the held-out 16 as
    its validation split. Returns each tree's root."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                              heldout_dataset)
    from ppn_tpu_torch.testing import write_coco_set, write_mpii_set

    mpii, coco = get_config("mpii_r18_384"), get_config("coco_r18_384")
    held = heldout_dataset(mpii, num_persons=2)
    roots = {k: os.path.join(d, k) for k in
             ("mpii_png", "mpii_jpg", "coco_png", "mpii_train_jpg")}
    for ext in ("png", "jpg"):
        write_mpii_set(mpii, roots[f"mpii_{ext}"],
                       {"train": (held, 16, 0), "valid": (held, 16, 0)}, ext)
    write_coco_set(roots["coco_png"],
                   heldout_dataset(coco, num_persons=2), 16)
    train = SyntheticPoseDataset(mpii, size=FILE_TRAIN_IMAGES, seed=0,
                                 cache=True, num_persons=2)
    write_mpii_set(mpii, roots["mpii_train_jpg"], {
        "train": (train, FILE_TRAIN_IMAGES, 0),
        "valid": (held, 16, 10_000)}, "jpg")
    return roots


def timed_oks(cfg, pred, dataset) -> tuple[dict, float, float]:
    """``evaluate_oks`` of ``pred.predict`` over the first 16 images of
    ``dataset`` at B=8: the summary, its wall seconds, those in predict."""
    from ppn_tpu_torch.eval.runner import evaluate_oks

    in_predict = []

    def predict(images):
        t0 = time.perf_counter()
        people = pred.predict(images)
        in_predict.append(time.perf_counter() - t0)
        return people

    t0 = time.perf_counter()
    summary = evaluate_oks(cfg, predict, dataset, max_images=16, batch_size=8)
    return summary, time.perf_counter() - t0, sum(in_predict)


def snapshot_pckh(ctx) -> dict:
    """Phase 5: PCKh of the committed MPII snapshot over the 16-image
    synthetic protocol at B=8 (det 0.02, nms 0.45): 0.9921 ± 3e-3 over
    378 joints. Its launch counts run on through phase 6."""
    from ppn_tpu_torch.eval.runner import evaluate_pckh
    from ppn_tpu_torch.ops import cuda_post, cuda_warp

    pred, val, calls = ctx.predictor, ctx.val, 0

    def predict(images):
        nonlocal calls
        calls += 1
        return pred.predict(images)

    cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
    t0 = time.perf_counter()
    summary = evaluate_pckh(ctx.cfg, predict, val, max_images=16,
                            batch_size=8)
    pckh, joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[main] PCKh {pckh:.4f} over {joints:.0f} joints "
        f"({time.perf_counter() - t0:.1f} s, {calls} predict calls)")
    if abs(pckh - PINNED_PCKH) >= 3e-3 or joints != PINNED_JOINTS:
        raise AssertionError(f"PCKh {pckh} / {joints} joints, pinned "
                             f"{PINNED_PCKH} / {PINNED_JOINTS}")
    return {"predict_calls": calls}


def predict_b128(ctx) -> dict:
    """Phase 6: uint8 (128, 384, 384, 3) through ``Predictor.predict``,
    one post launch a call (phase 5's calls counted in) and the median of
    20; the main-path map through the kernel against the plain version; the
    kernel's time at B=1 and 128 beside its plain version's and its bounds,
    its stage split from its %globaltimer stamps, the model's forward."""
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import feature_map_case

    pred, images, dev = ctx.predictor, ctx.images, ctx.dev
    calls = ctx.records["snapshot_pckh"]["predict_calls"]

    def predict():
        nonlocal calls
        calls += 1
        return pred.predict(images)

    B = images.shape[0]
    for _ in range(3):
        ppl = predict()
    for f in FLOATS:
        if not np.isfinite(getattr(ppl, f)).all():
            raise AssertionError(f"non-finite {f} at B={B}")
    med = statistics.median(event_times(predict, 20))
    launches = cuda_post.LAUNCHES
    if launches == 0 or launches != calls:
        raise AssertionError(f"{launches} kernel launches for {calls} calls")
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        fm128 = pred.model(x)
        fm1 = pred.model(x[:1])
    m = ctx.cfg.model
    got = cuda_post.postprocess_batch_cuda(m, fm128)
    want = postprocess_batch_plain(m, fm128)
    equal, ulp, err = compare(got, want)
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("kernel disagrees on the main-path map")
    times, post_stages = {}, {}
    for b, fm in ((1, fm1), (B, fm128)):
        call = functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
        times[b] = dict(post_time(m, fm), eager_ms=time_ms(call, 50),
                        host_us=host_us(call, 200))
    for kind, maps in (("main", {1: fm1, B: fm128}), ("normal", {
            b: torch.from_numpy(feature_map_case(m, b, seed=b)).to(dev)
            for b in (1, B)})):
        for b, fm in maps.items():
            us, span = post_stage_us(m, fm, 20)
            key = "stage_us_" + ("" if kind == "main" else "normal_")
            post_stages[f"{key}b{b}"] = dict(us, span=span)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: pred.model(x), 10)
    t1, t = times[1], times[B]
    return {"predict_ms": med,
            "post_ms": {b: v["ms"] for b, v in times.items()},
            "kernels": {"ppn_post_kernel": {
                "launches": launches, "max_ulp": ulp, "max_abs_err": err,
                "batch": B, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_ms_whole_map": t["bound_ms_whole_map"],
                "ms_eager": t["eager_ms"], "host_us_per_call": t["host_us"],
                "ms_b1": t1["ms"], "plain_ms_b1": t1["plain_ms"],
                "bound_ms_b1": t1["bound_ms"],
                "bound_ms_b1_whole_map": t1["bound_ms_whole_map"],
                "ms_eager_b1": t1["eager_ms"],
                "host_us_per_call_b1": t1["host_us"], **post_stages,
                "predict_ms_b128": med, "img_per_s_b128": 1e3 * B / med,
                "forward_ms_b128": fwd_ms}}}


def flip_tta(ctx) -> dict:
    """Phase 7: flip-TTA PCKh on phase 5's protocol: 0.98942 ± 3e-3 over
    378 joints (the JAX package's value), one post launch a predict call;
    then the B=128 TTA predict."""
    from ppn_tpu_torch.eval.runner import evaluate_pckh
    from ppn_tpu_torch.ops import cuda_post

    tpred, images, tcalls = ctx.tta_predictor, ctx.images, 0

    def tpredict(images):
        nonlocal tcalls
        tcalls += 1
        return tpred.predict(images)

    cuda_post.LAUNCHES = 0
    summary = evaluate_pckh(ctx.cfg, tpredict, ctx.val, max_images=16,
                            batch_size=8)
    tta_launches = cuda_post.LAUNCHES
    tta_pckh, tta_joints = summary["pckh/mean"], summary["pckh/num_joints"]
    if (abs(tta_pckh - PINNED_TTA_PCKH) >= 3e-3
            or tta_joints != PINNED_JOINTS or tta_launches != tcalls):
        raise AssertionError(f"flip-TTA PCKh {tta_pckh} / {tta_joints} "
                             f"joints, {tta_launches} launches in {tcalls} "
                             "calls")
    for _ in range(3):
        tpred.predict(images)
    tta_med = statistics.median(event_times(lambda: tpred.predict(images),
                                            20))
    return {"serving_slice": {
        "tta_pckh": tta_pckh, "tta_joints": tta_joints,
        "tta_launches": tta_launches, "tta_predict_calls": tcalls,
        "tta_predict_ms_b128": tta_med,
        "tta_img_per_s_b128": 1e3 * images.shape[0] / tta_med}}


def oks_eval(ctx) -> dict:
    """Phase 8: COCO OKS AP through ``Predictor`` and ``evaluate_oks``
    against the JAX package's values within 5e-3 (``OKS_PINS``), two post
    launches each, wall time cold and warm; then ``apps/evaluate.main
    --metric oks`` with the thresholds as flags and from a config.ini, its
    JSON the library's summary rounded to 4 places."""
    from ppn_tpu_torch.apps import evaluate
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import heldout_dataset
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post

    evaluation = {}
    for label, (name, snap, persons, thresholds, tta, pin,
                n_gt) in OKS_PINS.items():
        ecfg = get_config(name)
        if thresholds is not None:
            ecfg = dataclasses.replace(ecfg, model=dataclasses.replace(
                ecfg.model, detection_thresh=thresholds[0],
                nms_thresh=thresholds[1]))
        epred = Predictor.from_npz(ecfg, snap, flip_tta=tta)
        eval_set = heldout_dataset(ecfg, num_persons=persons)
        cuda_post.LAUNCHES = 0
        summary, first_s, _ = timed_oks(ecfg, epred, eval_set)
        e_launches = cuda_post.LAUNCHES
        # again, warm: cuDNN set up, images cached
        again, warm_s, predict_s = timed_oks(ecfg, epred, eval_set)
        evaluation[label] = dict(
            summary, launches=e_launches, pinned_ap=pin,
            repeat_equal=again == summary,
            first_ms_per_image=1e3 * first_s / 16,
            ms_per_image=1e3 * warm_s / 16,
            predict_ms_per_image=1e3 * predict_s / 16)
        if (abs(summary["oks/AP"] - pin) >= OKS_TOLERANCE
                or summary["oks/num_gt"] != n_gt or e_launches != 2):
            raise AssertionError(f"OKS evaluation {label}: {summary}, "
                                 f"{e_launches} launches")
        del epred
    # the CLI, with the thresholds as flags and from a config.ini
    want = {k: round(v, 4) for k, v in evaluation["coco"].items()
            if k.startswith("oks/")}
    argv = ["--config", "coco_r18_384", "--ckpt-dir", COCO_SNAPSHOT,
            "--metric", "oks", "--num-persons", "2", "--max-images", "16",
            "--batch-size", "8"]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        ini = os.path.join(d, "config.ini")
        with open(ini, "w") as fh:
            fh.write("[model]\ndetection_thresh = 0.02\nthresh = 0.6\n")
        for label, extra in (("flags", ["--detection-thresh", "0.02",
                                        "--nms-thresh", "0.6"]),
                             ("ini", ["--ini", ini])):
            cuda_post.LAUNCHES = 0
            returned, printed = quiet_call(evaluate.main, argv + extra)
            got = json.loads(printed)
            evaluation[f"cli_{label}"] = dict(got, launches=cuda_post.LAUNCHES)
            if got != want or returned != want or cuda_post.LAUNCHES != 2:
                raise AssertionError(f"evaluate CLI ({label}) printed {got},"
                                     f" the library {want}")
    return {"evaluation_slice": evaluation, "kernels": {"ppn_post_kernel": {
        "launches_evaluation_path": sum(v["launches"]
                                        for v in evaluation.values())}}}


def file_input(ctx) -> dict:
    """Phase 9: the evaluate CLI on the protocol images written as MPII PNGs,
    MPII JPEGs and COCO PNGs (``FILE_PINS``: the JAX package's values on
    the same files, exact counts, two post launches each), the sets' sha256
    beside the reference's, COCO's wall time cold and warm; the train CLI
    on 64 JPEGs from the snapshot (the device cache, one warp launch a step,
    an ``eval:`` from two post launches); the video CLI on a directory of
    JPEGs, its first frame's decisions equal to the plain pipeline's."""
    import PIL
    from PIL import features

    from ppn_tpu_torch.apps import evaluate, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.coco import make_coco_datasets
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post

    model, out = ctx.predictor.model, {}
    with scratch_dir("files_") as d:
        roots = write_file_sets(d)
        origin = {"pil": PIL.__version__,
                  "libjpeg_turbo": features.version("libjpeg_turbo"),
                  "mpii_jpg": sha256_of(os.path.join(roots["mpii_jpg"],
                                                     "images")),
                  "mpii_png": sha256_of(os.path.join(roots["mpii_png"],
                                                     "images"))}
        out["here"] = origin
        out["same_as_reference"] = {k: v == FILE_SET_ORIGIN[k]
                                    for k, v in origin.items()}

        for label, (name, snap, data, root, metric, (det, nms), pin, key,
                    count, tol) in FILE_PINS.items():
            cuda_post.LAUNCHES = 0
            t0 = time.perf_counter()
            summary, _ = quiet_call(evaluate.main, [
                "--config", name, "--data", data, "--data-root", roots[root],
                "--ckpt-dir", snap, "--metric", metric, "--max-images", "16",
                "--batch-size", "8", "--detection-thresh", str(det),
                "--nms-thresh", str(nms)])
            wall = time.perf_counter() - t0
            launches = cuda_post.LAUNCHES
            value = summary["pckh/mean" if metric == "pckh" else "oks/AP"]
            out[label] = dict(summary, launches=launches, pinned=pin,
                              cli_s=wall)
            if (abs(value - pin) >= tol or summary[key] != count
                    or launches != 2):
                raise AssertionError(f"evaluation on files {label}: "
                                     f"{summary}, {launches} launches")

        # the COCO files' wall time per image, cold and warm, and decoding
        ccfg = get_config("coco_r18_384")
        ccfg = dataclasses.replace(ccfg, model=dataclasses.replace(
            ccfg.model, detection_thresh=0.02, nms_thresh=0.6))
        _, cval = make_coco_datasets(ccfg, roots["coco_png"])
        cpred = Predictor.from_npz(ccfg, COCO_SNAPSHOT)
        passes = [timed_oks(ccfg, cpred, cval) for _ in range(2)]  # cold, warm
        ap = passes[1][0]["oks/AP"]
        t0 = time.perf_counter()
        for i in range(16):
            cval[i]
        decode_s = time.perf_counter() - t0
        out["coco_png"]["ap_unrounded"] = ap
        out["coco_timing"] = {
            "cold_ms_per_image": 1e3 * passes[0][1] / 16,
            "cold_predict_ms_per_image": 1e3 * passes[0][2] / 16,
            "warm_ms_per_image": 1e3 * passes[1][1] / 16,
            "warm_predict_ms_per_image": 1e3 * passes[1][2] / 16,
            "decode_ms_per_image": 1e3 * decode_s / 16}
        del cpred

        # training on files
        run = train_cli([
            "--config", "mpii_r18_384", "--data", "mpii", "--data-root",
            roots["mpii_train_jpg"], "--init-npz", SNAPSHOT, "--steps",
            str(FILE_TRAIN_STEPS)], os.path.join(d, "ckpt"))
        printed, evals = run.pop("printed"), run.pop("evals")
        cached = f"device cache: {FILE_TRAIN_IMAGES} samples" in printed
        out["train"] = dict(run, device_cache=cached,
                            eval=evals[0] if evals else None)
        losses, warp, post = (run[k] for k in ("losses", "warp_launches",
                                               "post_launches"))
        if (not cached or len(losses) != FILE_TRAIN_STEPS
                or not all(math.isfinite(v) for v in losses)
                or warp != FILE_TRAIN_STEPS or post != 2 or len(evals) != 1
                or not math.isfinite(evals[0]["pckh/mean"])):
            raise AssertionError(f"training on files: {out['train']}")

        # video from a directory of JPEGs
        frames_dir = os.path.join(roots["mpii_jpg"], "images")
        vcfg = get_config("mpii_r18_384")    # the video app's thresholds
        frame0 = next(video.jpeg_frames(frames_dir, 1, vcfg.model.insize))
        equal, ulp, _ = frame_vs_plain(vcfg, model, frame0)
        summary = video_cli([
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            frames_dir, "--frames", str(FILE_VIDEO_FRAMES)])
        out["video"] = dict(summary, first_frame_decisions_equal=equal,
                            first_frame_max_ulp=ulp)
        if not equal or ulp > ULP_LIMIT:
            raise AssertionError(f"video from a directory: {out['video']}")
    return {"file_input_slice": out, "kernels": {
        "ppn_post_kernel": {"launches_file_input": sum(
            out[k]["launches"] for k in FILE_PINS)
            + out["train"]["post_launches"] + out["video"]["launches"]},
        "ppn_warp_kernel": {
            "launches_file_training": out["train"]["warp_launches"]}}}


def latency_b1(ctx) -> dict:
    """Phase 10: ``predict_single`` p50 and p90 over 200 calls without and
    with TTA, one post launch a call; the split of one B=1 call."""
    from ppn_tpu_torch.inference import fetch_async, wait_host
    from ppn_tpu_torch.ops import cuda_post

    pred, tpred, images = ctx.predictor, ctx.tta_predictor, ctx.images
    m, dev, one = ctx.cfg.model, ctx.dev, images[0]
    latency = {}
    for label, p_ in (("plain", pred), ("tta", tpred)):
        for _ in range(10):
            p_.predict_single(one)
        cuda_post.LAUNCHES = 0
        p50, p90 = percentiles_ms(lambda: p_.predict_single(one),
                                  LATENCY_CALLS)
        latency[label] = {"p50_ms": p50, "p90_ms": p90,
                          "launches": cuda_post.LAUNCHES}
        if cuda_post.LAUNCHES != LATENCY_CALLS:
            raise AssertionError(f"{cuda_post.LAUNCHES} post launches in "
                                 f"{LATENCY_CALLS} B=1 calls")
    x1_host = torch.from_numpy(one[None])
    x1 = x1_host.to(dev)
    with torch.no_grad():
        split = {"h2d": events_ms(lambda: x1_host.to(dev), 50),
                 "forward": events_ms(lambda: pred.model(x1), 50)}
        fm1 = pred.model(x1)
    call1 = functools.partial(cuda_post.postprocess_batch_cuda, m, fm1)
    split["post_kernel_device"] = graph_ms(call1, 50)
    split["post_wrapper_host_us"] = host_us(call1, 200)
    split["post_eager"] = events_ms(call1, 50)
    ppl1 = call1()
    split["d2h"] = events_ms(lambda: wait_host(*fetch_async(ppl1)), 50)
    return {"serving_slice": {"b1_latency": latency, "b1_split_ms": split}}


def serve_selftest(ctx) -> dict:
    """Phase 11: the ``apps/serve.main`` self-test (64 requests, 8 threads,
    max batch 32): every request bitwise a direct predict, one post launch
    per predict call."""
    from ppn_tpu_torch.apps import serve
    from ppn_tpu_torch.ops import cuda_post

    requests, max_batch = 64, 32
    cuda_post.LAUNCHES = 0
    rc, printed = quiet_call(serve.main, [
        "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--selftest",
        str(requests), "--threads", "8", "--max-batch", str(max_batch),
        "--window-ms", "5", "--json"])
    serve_launches = cuda_post.LAUNCHES
    server = json.loads(printed.strip().splitlines()[-1])
    # one launch per predict call: the warm-up runs each bucket 1..max_batch
    # for uint8 and f32, the server one per batch, and the self-test's
    # check one per chunk of the requests at each bucket it saw
    warm = 2 * max_batch.bit_length()
    served = sum(server["batches_by_size"].values())
    direct = sum(-(-requests // int(b)) for b in server["batches_by_size"])
    server["launches"] = served
    log(f"[serve] ppn_post_kernel launches {serve_launches} = {warm} "
        f"warm-up + {served} batches served + {direct} direct predicts of "
        "the check")
    if (rc != 0 or server["mismatches"] != 0
            or serve_launches != warm + served + direct):
        raise AssertionError(f"server self-test failed: rc {rc}, "
                             f"{serve_launches} launches, {server}")
    return {"serving_slice": {"server": server}}


def video_stream(ctx) -> dict:
    """Phase 12: ``apps/video.main`` on 64 synthetic 720p frames, pipelined
    and not: one post launch a frame and the warm-up, the first frame's
    decisions equal to the plain pipeline's. Frees the snapshot's
    predictors, which no later phase uses."""
    from ppn_tpu_torch.apps import video
    from ppn_tpu_torch.configs import get_config

    vcfg = get_config("mpii_r18_384")    # the video app's thresholds
    frame0 = next(video.synthetic_frames(1, fps=0))
    equal, ulp, persons = frame_vs_plain(vcfg, ctx.predictor.model, frame0)
    log(f"[video] first 720p frame through the pipeline against the plain "
        f"pipeline: decisions_equal={equal} max_ulp={ulp} persons {persons}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("video pipeline disagrees with the plain one")
    videos = {}
    for label, extra in (("overlap", []), ("no_overlap", ["--no-overlap"])):
        videos[label] = video_cli([
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            "synthetic", "--frames", str(VIDEO_FRAMES), *extra])
    ctx.drop("predictor", "tta_predictor")
    return {"serving_slice": {"video": videos}}
