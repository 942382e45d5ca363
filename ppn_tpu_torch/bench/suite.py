"""The benchmark suite (port of ``ppn_tpu/bench/suite.py``): its twelve
configs through the port's main paths.

1. Single 384×384 image latency: forward + one ``ppn_post_kernel`` launch.
2. Batched (B=32) inference throughput.
3. Training step (augmentation through ``ppn_warp_kernel``, encode,
   forward/backward, SGD + EMA) at B=32; 3b at B=128; 3c the K-step loop
   over a ``DeviceCache``.
4. COCO pipeline (K=17); 4b the crowded preset at B=128, with MFU.
5. Streaming 720p video (``apps/video.py``); 5p with the host pre-resize.
6. JPEG→poses: the native decode pool → card → poses on the host.
7. Micro-batched serving (``apps/serve.py`` self-test); 7w its batch
   window swept.

    python -m ppn_tpu_torch.bench.suite [--configs 1,2,5] [--out results.json]

Each record: {"config", "metric", "value", "unit", ..., "card"}, the JAX
suite's keys without its remote-tunnel fields, and ``card``: the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
(``"cpu"`` on the CPU). Every function runs on ``cuda`` unless asked for
``device="cpu"``, and any failure raises: no record stands in for a
config that did not run.

Timers (``utils/profiling.py``). ``device_ms``, ``device_step_ms`` and
``device_batch_ms`` are ``device_latency_ms``: the slope between runs of
``iters`` and ``2·iters`` back-to-back eager calls, timed with CUDA events.
Where the host's enqueue outlasts the device's work (B=1, the video frame)
that slope measures the host issuing launches, not the card; the JAX
suite's slope instead chains the calls inside one compiled program.
``mfu_pct`` counts only the forward's conv and matmul FLOPs
(``forward_flops``) against the card's data-sheet dense bf16 peak
(``peak_bf16_tflops``); the JAX suite's XLA cost analysis also counts
elementwise and post-process work, so the two are not comparable.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.utils.profiling import (device_latency_ms,
                                           latency_percentiles, timeit)

# BASELINE.json's target: ≥ 500 images/s on one accelerator
BASELINE_IMAGES_PER_SEC = 500.0
# Dense bf16 tensor-core peaks, TFLOP/s, from NVIDIA's H100 Tensor Core GPU
# data sheet; its 1,979 (SXM) and 1,513 (PCIe) are with 2:4 sparsity.
DENSE_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4,
                     "NVIDIA H100 PCIe": 756.0}
FLOPS_SOURCE = "torch flop_counter: conv+matmul of the forward"


def card(device) -> str:
    """The card a record was measured on: ``nvidia-smi``'s name and power
    limit for a CUDA device (raises when the command fails), else the
    device type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peak_bf16_tflops(device) -> float:
    """The device's dense bf16 peak in TFLOP/s: ``PPN_PEAK_TFLOPS`` when
    set, else the data sheet's for the card's name. Raises, naming the
    device, for a card the table lacks."""
    env = os.environ.get("PPN_PEAK_TFLOPS")
    if env:
        return float(env)
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    if name not in DENSE_BF16_TFLOPS:
        raise ValueError(f"no data-sheet bf16 peak for {name!r}; set "
                         "PPN_PEAK_TFLOPS (TFLOP/s)")
    return DENSE_BF16_TFLOPS[name]


def forward_flops(cfg, batch: int) -> int:
    """FLOPs of the model's forward on ``batch`` images: its convolutions
    and matmuls, two per multiply-add, counted by
    ``torch.utils.flop_counter`` on a copy of the model on the meta device
    (no memory, no arithmetic; the count does not depend on the dtype).
    ``pad_same``'s padding, BatchNorm, the activations, the normalize and
    the post-process are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from ppn_tpu_torch.nn.model import PoseProposalNet

    with torch.device("meta"):
        model = PoseProposalNet(cfg.model, dtype=torch.float32).eval()
        images = torch.empty((batch, *cfg.model.insize, 3))
    counter = FlopCounterMode(display=False)
    with counter:
        model(images)
    return counter.get_total_flops()


def _flagship(config_name="mpii_r18_384", device=None):
    """(cfg, an eval-mode model of the port's seeded init in the config's
    compute dtype on ``device``)."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.train.steps import _seeded_model

    cfg = get_config(config_name)
    dev = resolve_device(device)
    return cfg, _seeded_model(cfg, cfg.train.seed).to(dev).eval()


def _pipeline_body(cfg, model):
    """images → (kp_box, kp_score, valid) on the model's device: the model
    and one post-process launch (``ops/postprocess.forward_postprocess_fast``,
    the path ``Predictor.predict`` runs), nothing waited for."""
    from ppn_tpu_torch.ops.postprocess import forward_postprocess_fast

    dev = next(model.parameters()).device

    def body(images):
        p = forward_postprocess_fast(cfg.model, model, images, device=dev)
        return p.kp_box, p.kp_score, p.valid

    return body


def _images(cfg, batch: int, dev) -> torch.Tensor:
    """The JAX suite's inputs: seeded f32 pixels in [0, 1], put on the
    device once."""
    return torch.from_numpy(np.random.default_rng(0).random(
        (batch, *cfg.model.insize, 3), np.float32)).to(dev)


_SESSION_REF: Dict = {}


def session_ref_p50_ms(config_name="mpii_r18_384", device=None) -> float:
    """Config 1's single-image end-to-end p50, measured once per process
    (per config and device type). Every latency record carries it, so a value
    can be read against its own run's reference when the shared host
    drifts between runs."""
    dev = resolve_device(device)
    key = (config_name, dev.type)
    if key not in _SESSION_REF:
        cfg, model = _flagship(config_name, dev)
        lat = latency_percentiles(_pipeline_body(cfg, model),
                                  _images(cfg, 1, dev), calls=30)
        _SESSION_REF[key] = round(lat["p50_ms"], 3)
    return _SESSION_REF[key]


def _timed_ms(dev_ms: float, config_name: str, batch: int) -> float:
    """``dev_ms``, a ``device_latency_ms`` slope that a rate is computed
    from, if it is positive. A slope of 0 (the longer runs no slower than
    the shorter, as on a loaded host at few calls) gives no rate: raise
    instead of dividing by it."""
    if not dev_ms > 0:
        raise RuntimeError(
            f"{config_name} at batch {batch}: the timed body measured no "
            f"time (device slope {dev_ms} ms); time it over more calls")
    return dev_ms


def bench_single_latency(calls: int = 50, iters: int = 32,
                         config_name="mpii_r18_384", device=None) -> Dict:
    """B=1 end-to-end latency over ``calls`` calls, each waited for, and
    ``device_ms``, the slope over ``iters`` and ``2·iters`` calls."""
    cfg, model = _flagship(config_name, device)
    dev = next(model.parameters()).device
    body = _pipeline_body(cfg, model)
    img = _images(cfg, 1, dev)
    lat = latency_percentiles(body, img, calls=calls)
    dev_ms = device_latency_ms(body, img, iters=iters)
    # config 1 is the session reference: record its own p50 as such
    ref = _SESSION_REF.setdefault((config_name, dev.type),
                                  round(lat["p50_ms"], 3))
    return {"config": "1_single_image_latency",
            "metric": "p50_latency", "value": round(lat["p50_ms"], 3),
            "unit": "ms", **{k: round(v, 3) for k, v in lat.items()},
            "device_ms": round(dev_ms, 3), "session_ref_p50_ms": ref,
            "card": card(dev)}


def _throughput(config_name: str, batch: int, iters: int, dev) -> float:
    cfg, model = _flagship(config_name, dev)
    t = timeit(_pipeline_body(cfg, model), _images(cfg, batch, dev),
               iters=iters)
    return batch / t


def bench_batched_inference(batch: int = 32, iters: int = 30,
                            config_name="mpii_r18_384", device=None) -> Dict:
    dev = resolve_device(device)
    ips = _throughput(config_name, batch, iters, dev)
    return {"config": "2_batched_inference",
            "metric": "images_per_sec_chip", "value": round(ips, 2),
            "unit": "images/sec", "batch": batch,
            "vs_baseline": round(ips / BASELINE_IMAGES_PER_SEC, 4),
            "card": card(dev)}


def _train_setup(config_name: str, dev, **train):
    """(cfg with ``train`` fields replaced, the mesh over the process
    group's world, a fresh train state replicated over it)."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.parallel import make_mesh, replicate
    from ppn_tpu_torch.train.steps import create_train_state

    cfg = get_config(config_name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train))
    mesh = make_mesh(device=dev)
    return cfg, mesh, replicate(mesh, create_train_state(cfg, device=dev))


def bench_train_step(batch: int = 32, iters: int = 20, device_iters: int = 8,
                     config_name="mpii_r18_384", device=None) -> Dict:
    """``train_step`` with augmentation on a collated synthetic batch held
    on the device: a host loop of ``iters`` steps, and ``device_step_ms``,
    the slope over ``device_iters`` and twice as many back-to-back steps (augment + encode + forward/backward + SGD
    + EMA). ``train_step`` advances the state in place, so each step runs
    from the state the last one left, in both timings."""
    from ppn_tpu_torch.data.pipeline import collate
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.parallel import shard_batch
    from ppn_tpu_torch.train.steps import BATCH_KEYS, train_step

    dev = resolve_device(device)
    cfg, mesh, state = _train_setup(config_name, dev, batch_size=batch)
    ds = SyntheticPoseDataset(cfg, size=batch, seed=0)
    batch_np = collate([ds[i] for i in range(batch)])
    batch_dev = shard_batch(mesh, {k: torch.from_numpy(batch_np[k]).to(dev)
                                   for k in BATCH_KEYS})

    def step():
        return train_step(cfg, state, batch_dev, augment=True, mesh=mesh)

    step()["loss_total"].item()   # first-call set-up outside the timings
    t0 = time.perf_counter()
    for _ in range(iters):
        terms = step()
    terms["loss_total"].item()
    t = (time.perf_counter() - t0) / iters
    dev_ms = _timed_ms(device_latency_ms(step, iters=device_iters),
                       config_name, batch)
    return {"config": "3_train_step",
            "metric": "train_images_per_sec",
            "value": round(batch / dev_ms * 1e3, 2),
            "unit": "images/sec", "batch": batch,
            "devices": mesh.size(),
            "device_step_ms": round(dev_ms, 3),
            "host_loop_images_per_sec": round(batch / t, 2),
            "card": card(dev)}


def bench_train_device_resident(batch: int = 128, k: int = 8,
                                cache_size: int = 256, iters: int = 4,
                                config_name: str = "mpii_r18_384",
                                device=None) -> Dict:
    """Config 3c: the trainer's device-resident loop end to end: the
    dataset lives on the device (``data/device_cache.DeviceCache``, uint8
    images), each call runs ``k`` SGD steps
    (``train/steps.make_multi_train_step``) over one (k, B) int32 index
    block from the host; ``iters`` calls after one warm-up call,
    host-timed, everything included."""
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.train.steps import make_multi_train_step

    dev = resolve_device(device)
    cfg, mesh, state = _train_setup(config_name, dev, batch_size=batch,
                                    steps_per_call=k)
    ds = SyntheticPoseDataset(cfg, size=cache_size, seed=0)
    cache = DeviceCache(ds, image_uint8=True, device=dev,
                        mesh=mesh if mesh.size() > 1 else None)
    multi = make_multi_train_step(cfg, augment=True, steps_per_call=k,
                                  mesh=mesh)
    rng = np.random.default_rng(0)

    def block():
        return rng.integers(0, cache.size, (k, batch)).astype(np.int32)

    multi(state, cache, block())["loss_total"].item()  # first-call set-up
    t0 = time.perf_counter()
    for _ in range(iters):
        terms = multi(state, cache, block())
    terms["loss_total"].item()
    per_step_ms = (time.perf_counter() - t0) / (iters * k) * 1e3
    return {"config": "3c_train_device_resident",
            "metric": "train_images_per_sec",
            "value": round(batch / per_step_ms * 1e3, 2),
            "unit": "images/sec", "batch": batch, "steps_per_call": k,
            "devices": mesh.size(),
            "host_loop_step_ms": round(per_step_ms, 3),
            "note": "host-timed end-to-end; one (k,B) int32 block per "
                    "dispatch — per-dispatch overhead amortized over k "
                    "steps",
            "card": card(dev)}


def bench_coco_pipeline(batch: int = 32, iters: int = 30,
                        config_name="coco_r18_384", device=None) -> Dict:
    dev = resolve_device(device)
    ips = _throughput(config_name, batch, iters, dev)
    return {"config": "4_coco_pipeline",
            "metric": "images_per_sec_chip", "value": round(ips, 2),
            "unit": "images/sec", "batch": batch, "card": card(dev)}


def serving_batch(config_name: str, batch: int, iters: int,
                  device_iters: int, device=None, warmup: int = 2):
    """The flagship body at ``batch`` on seeded f32 images held on the
    device, measured as config 4b and the headline measure it: a host
    loop (``timeit``: ``warmup`` calls, the best of 3 runs of ``iters``),
    ``device_batch_ms`` over ``device_iters`` and twice as many
    back-to-back calls, img/s from it and MFU. Returns (cfg, device,
    fields of the record)."""
    cfg, model = _flagship(config_name, device)
    dev = next(model.parameters()).device
    peak = peak_bf16_tflops(dev) * 1e12
    flops = forward_flops(cfg, batch) / batch
    body = _pipeline_body(cfg, model)
    imgs = _images(cfg, batch, dev)
    t = timeit(body, imgs, iters=iters, warmup=warmup)
    dev_ms = _timed_ms(device_latency_ms(body, imgs, iters=device_iters),
                       config_name, batch)
    ips = batch / dev_ms * 1e3
    return cfg, dev, {"value": round(ips, 2),
                      "device_batch_ms": round(dev_ms, 3),
                      "mfu_pct": round(flops * ips / peak * 100.0, 2),
                      "flops_source": FLOPS_SOURCE,
                      "host_loop_images_per_sec": round(batch / t, 2)}


def bench_coco_crowded(batch: int = 128, iters: int = 20,
                       device_iters: int = 10,
                       config_name="coco_r18_384_crowded",
                       device=None) -> Dict:
    """Config 4b: the COCO crowded operating point (det 0.02 / nms 0.6) at
    the serving batch B=128 (``serving_batch``)."""
    cfg, dev, m = serving_batch(config_name, batch, iters, device_iters,
                                device)
    return {"config": "4b_coco_crowded_serving_batch",
            "metric": "images_per_sec_chip", "value": m["value"],
            "unit": "images/sec", "batch": batch,
            "preset": config_name,
            "det_thresh": cfg.model.detection_thresh,
            "nms_thresh": cfg.model.nms_thresh,
            "device_batch_ms": m["device_batch_ms"],
            "mfu_pct": m["mfu_pct"],
            "flops_source": m["flops_source"],
            "host_loop_images_per_sec": m["host_loop_images_per_sec"],
            "card": card(dev)}


def _last_json_line(text: str) -> Dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def bench_video_stream(frames: int = 64, pre_resize: bool = False,
                       iters: int = 32, config_name="mpii_r18_384",
                       device=None) -> Dict:
    """The streaming loop of ``apps/video.py`` (capture thread, latest-frame
    slot, double-buffered dispatch and fetch) on synthetic 720p frames, as
    the app reports it, and ``device_ms``: the slope over ``iters`` and
    ``2·iters`` back-to-back calls of the app's per-frame body (``make_video_pipeline``) on a uint8
    (720, 1280, 3) host frame: pinned upload, /255, on-device resize, the
    model and one post-process launch. ``pre_resize`` (config 5p): the
    host downscales each frame before its upload."""
    from ppn_tpu_torch.apps import video

    dev = resolve_device(device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        video.main(["--config", config_name, "--source", "synthetic",
                    "--frames", str(frames), "--json", "--device", str(dev)]
                   + (["--pre-resize"] if pre_resize else []))
    summary = _last_json_line(buf.getvalue())

    cfg, model = _flagship(config_name, dev)
    frame = np.random.default_rng(0).integers(0, 255, (720, 1280, 3),
                                              dtype=np.uint8)
    dev_ms = device_latency_ms(video.make_video_pipeline(cfg, model), frame,
                               iters=iters)
    return {"config": ("5p_video_stream_720p_preresize" if pre_resize
                       else "5_video_stream_720p"),
            "metric": "p50_latency", "value": summary["p50_ms"],
            "unit": "ms", "p50_ms": summary["p50_ms"],
            "p90_ms": summary["p90_ms"], "fps": summary["fps"],
            "frames": summary["frames"],
            "pre_resize": pre_resize,
            "device_ms": round(dev_ms, 3),
            "session_ref_p50_ms": session_ref_p50_ms(config_name, dev),
            "loop": "apps.video double-buffered",
            "card": card(dev)}


def bench_jpeg_to_poses(n_frames: int = 96, config_name="mpii_r18_384",
                        device=None) -> Dict:
    """JPEG bytes → poses on the host, end to end.

    Eight distinct synthetic 720p frames are JPEG-encoded once by PIL
    (quality 90, not timed) and cycled to ``n_frames``. Timed: the native
    decode+resize pool alone (``native/loader.NativeJpegLoader``, 8
    workers), the serial per-frame latency (bytes → pool → upload → model
    → one post-process launch → poses fetched), and the sustained rate with
    the pool and the device overlapped. The pool failing to build or load,
    or a frame failing to decode, raises."""
    from PIL import Image

    from ppn_tpu_torch.native.loader import NativeJpegLoader

    cfg, model = _flagship(config_name, device)
    dev = next(model.parameters()).device
    body = _pipeline_body(cfg, model)

    rng = np.random.default_rng(0)
    frames = []
    for _ in range(8):  # 8 distinct frames cycled n_frames times
        arr = (rng.random((720, 1280, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        frames.append(buf.getvalue())
    jpegs = [frames[i % len(frames)] for i in range(n_frames)]

    def decoded(loader) -> np.ndarray:
        rid, img = loader.get()
        if img is None:
            raise ValueError(f"frame {rid} failed to decode")
        return img

    def fetched(out):
        return [t.cpu() for t in out]

    loader = NativeJpegLoader(cfg.model.insize, num_workers=8)
    try:
        # warm-up: one frame through the whole path
        loader.submit(0, jpegs[0])
        fetched(body(decoded(loader)[None]))

        # decode-pool-only throughput
        t0 = time.perf_counter()
        for i, data in enumerate(jpegs):
            loader.submit(i, data)
        for _ in jpegs:
            decoded(loader)
        decode_ips = n_frames / (time.perf_counter() - t0)

        # serial per-frame latency: JPEG bytes → fetched poses
        lats = []
        for data in jpegs:
            t0 = time.perf_counter()
            loader.submit(0, data)
            fetched(body(decoded(loader)[None]))
            lats.append((time.perf_counter() - t0) * 1e3)
        lats = np.sort(np.asarray(lats))

        # pipelined sustained throughput: pool and device overlapped
        t0 = time.perf_counter()
        for i, data in enumerate(jpegs):
            loader.submit(i, data)
        out = None
        for _ in jpegs:
            out = body(decoded(loader)[None])
        fetched(out)
        sustained_ips = n_frames / (time.perf_counter() - t0)
    finally:
        loader.close()

    p50 = round(float(lats[len(lats) // 2]), 3)
    return {"config": "6_jpeg_to_poses", "metric": "p50_latency",
            "unit": "ms", "frames": n_frames, "value": p50, "p50_ms": p50,
            "p90_ms": round(float(lats[int(len(lats) * 0.9)]), 3),
            "sustained_images_per_sec": round(sustained_ips, 2),
            "decode_pool_images_per_sec": round(decode_ips, 2),
            "session_ref_p50_ms": session_ref_p50_ms(config_name, dev),
            "card": card(dev)}


def bench_serving(n: int = 512, threads: int = 16, max_batch: int = 32,
                  window_ms: float = 3, config_name="mpii_r18_384",
                  device=None) -> Dict:
    """Micro-batched serving: ``apps/serve.py``'s self-test, N client
    threads submitting single images to a ``PoseServer``; sustained img/s,
    per-request latency, the batch histogram, and the requests whose poses
    differ from a direct predict (``mismatches``, the self-test's exit
    code ``selftest_rc``)."""
    from ppn_tpu_torch.apps import serve

    dev = resolve_device(device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--config", config_name,
                         "--selftest", str(n), "--threads", str(threads),
                         "--max-batch", str(max_batch),
                         "--window-ms", str(window_ms), "--json",
                         "--device", str(dev)])
    rec = _last_json_line(buf.getvalue())
    return {"config": "7_serving_microbatch", "metric": "images_per_sec",
            "value": rec["images_per_sec"], "unit": "images/sec",
            "selftest_rc": rc, **{k: rec[k] for k in (
                "p50_ms", "p90_ms", "batches_by_size", "mismatches",
                "threads", "requests")},
            "window_ms": window_ms,
            "session_ref_p50_ms": session_ref_p50_ms(config_name, dev),
            "card": card(dev)}


def bench_serving_window_sweep(windows=(2, 5, 10, 20), n: int = 512,
                               threads: int = 16,
                               config_name="mpii_r18_384",
                               device=None) -> Dict:
    """Config 7w: config 7 at each batch window, the load fixed; each
    server is closed before the next starts."""
    dev = resolve_device(device)
    points = []
    for w in windows:
        rec = bench_serving(n=n, threads=threads, window_ms=w,
                            config_name=config_name, device=dev)
        points.append({k: rec[k] for k in (
            "window_ms", "value", "p50_ms", "p90_ms", "batches_by_size",
            "mismatches", "selftest_rc")})
    return {"config": "7w_serving_window_sweep",
            "metric": "images_per_sec_by_window",
            "value": points[0]["value"], "unit": "images/sec",
            "points": points,
            "session_ref_p50_ms": session_ref_p50_ms(config_name, dev),
            "card": card(dev)}


_BENCHES = {
    "1": bench_single_latency,
    "2": bench_batched_inference,
    "3": bench_train_step,
    # training at the serving batch
    "3b": functools.partial(bench_train_step, batch=128),
    # the device-resident K-step loop
    "3c": bench_train_device_resident,
    "4": bench_coco_pipeline,
    "5": bench_video_stream,
    # the host pre-upload downscale
    "5p": functools.partial(bench_video_stream, pre_resize=True),
    "6": bench_jpeg_to_poses,
    "7": bench_serving,
    # the batch window swept at fixed load
    "7w": bench_serving_window_sweep,
    # the COCO crowded operating point at the serving batch
    "4b": bench_coco_crowded,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="PPN benchmark suite")
    p.add_argument("--configs", default="1,2,3,3b,3c,4,5,6,7")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    results: List[Dict] = []
    for c in args.configs.split(","):
        c = c.strip()
        print(f"running benchmark {c}...", flush=True)
        rec = _BENCHES[c]()
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
