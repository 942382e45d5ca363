"""Streaming video pose CLI (port of ``ppn_tpu/apps/video.py``).

A capture thread feeds a latest-frame slot; the main loop sends each frame
through the pipeline on the card — upload, ``/255``, the bilinear resize to
the model input (``ops/image.resize_bilinear``), the model and one
``ppn_post_kernel`` launch — and a consumer thread waits for each frame's
poses on the host. Sources:

* ``--source synthetic`` — generated 720p frames, pre-rendered and paced at
  30 fps, so the latency path runs offline;
* ``--source <directory>`` — its ``.jpg``/``.jpeg`` files in name order,
  cycled to ``--frames``, decoded and resized to the model input by the
  native libjpeg pool (``native/loader.NativeJpegLoader``, four threads
  off the GIL), in file order;
* ``--source cam`` / ``--source <video file>`` — OpenCV capture (cv2,
  imported only for it).

``--pre-resize`` and ``--out`` need PIL, imported only for them. Reports
frames, fps and the p50/p90 of the latency from frame in hand to poses on
the host.

    python -m ppn_tpu_torch.apps.video --config mpii_r18_384 \
        --ckpt-dir artifacts/mpii_hero_r5_ema_f16.npz --source synthetic \
        --frames 64 --json
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch


def make_video_pipeline(cfg, state_or_model, pre_resized: bool = False):
    """uint8 frame (H0, W0, 3) → one image's ``People`` on the model's
    device (``inference.fetch_async`` brings them to the host).

    ``state_or_model`` is a ``TrainState`` (its eval parameters are used)
    or an eval-mode ``PoseProposalNet``. The frame goes up without a host
    sync (pinned memory on the card), is scaled to [0, 1] and resized to
    ``insize`` on the device — unless ``pre_resized``, when it arrives at
    ``insize`` already (``--pre-resize``) — then the model and one
    post-process launch follow; nothing waits for the device."""
    from ppn_tpu_torch.ops import postprocess as post
    from ppn_tpu_torch.ops.image import resize_bilinear
    from ppn_tpu_torch.ops.parse import People
    from ppn_tpu_torch.train.steps import TrainState, eval_model

    model = (eval_model(state_or_model)
             if isinstance(state_or_model, TrainState) else state_or_model)
    model.eval()
    dev = next(model.parameters()).device
    m = cfg.model

    @torch.no_grad()
    def run(frame_u8: np.ndarray) -> People:
        x = torch.from_numpy(np.require(frame_u8, requirements=("C", "W")))
        if dev.type == "cuda":
            x = x.pin_memory().to(dev, non_blocking=True)
        img = x.to(torch.float32) / 255.0
        if not pre_resized:
            img = resize_bilinear(img, m.insize)
        people = post.postprocess_batch_fast(m, model(img[None]))
        return People(*(t[0] for t in people))

    return run


def host_resize(frame_u8: np.ndarray, insize) -> np.ndarray:
    """Host-side uint8 bilinear downscale to the model input (PIL). Its taps
    differ from the device ``resize_bilinear`` in the last bits."""
    from PIL import Image

    if frame_u8.shape[:2] == tuple(insize):
        return frame_u8
    return np.asarray(Image.fromarray(frame_u8).resize(
        (insize[1], insize[0]), Image.BILINEAR))


def synthetic_frames(n: int, size=(720, 1280), seed: int = 0,
                     pool: int = 16, fps: float = 30.0):
    """Deterministic frames with moving stick figures.

    A small pool of frames is rendered before streaming starts and cycled
    (rendering costs tens of ms a frame on the host, while a camera
    delivers frames for free), and frames are paced at ``fps``: an unpaced
    pool races through the stream while the consumer handles its first
    frame, and the latest-frame slot then drops nearly everything. The
    pipeline's own rate shows as frames processed over wall time, at most
    ``fps``."""
    import dataclasses

    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    cfg = get_config("mpii_r18_384")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, insize=size,
                                       outsize=(size[0] // 32,
                                                size[1] // 32)))
    uniq = min(n, pool)
    ds = SyntheticPoseDataset(cfg, size=uniq, seed=seed, num_persons=2)
    frames = [(ds[i]["image"] * 255).astype(np.uint8) for i in range(uniq)]
    period = 1.0 / fps if fps > 0 else 0.0
    t_next = time.perf_counter()
    for i in range(n):
        if period:
            now = time.perf_counter()
            delay = t_next - now
            if delay > 0:
                time.sleep(delay)
            # no catch-up bursts: a camera stalled by its consumer drops
            # those frames instead of delivering them at once
            t_next = max(t_next, now) + period
        yield frames[i % uniq]


def jpeg_frames(dirpath: str, n: int, insize):
    """``n`` uint8 frames at ``insize`` from the sorted ``.jpg``/``.jpeg``
    files of a directory, cycled, through the native decode pool: submits
    run a window of 8 ahead of consumption, completions (out of order, four
    workers race) are buffered by id and yielded in file order, and a frame
    that fails to decode is skipped. Raises ``RuntimeError`` when the
    directory holds none, or when the pool cannot be built."""
    from ppn_tpu_torch.native.loader import NativeJpegLoader

    files = sorted(
        os.path.join(dirpath, f) for f in os.listdir(dirpath)
        if f.lower().endswith((".jpg", ".jpeg")))
    if not files:
        raise RuntimeError(f"no .jpg files in {dirpath!r}")
    paths = [files[i % len(files)] for i in range(n)]

    def submit(i):
        with open(paths[i], "rb") as f:
            loader.submit(i, f.read())

    loader = NativeJpegLoader(insize, num_workers=4)
    try:
        window = min(8, n)
        for i in range(window):
            submit(i)
        submitted, pending, next_id = window, {}, 0
        for _ in range(n):
            rid, img = loader.get()
            pending[rid] = img
            if submitted < n:
                submit(submitted)
                submitted += 1
            while next_id in pending:
                img = pending.pop(next_id)
                next_id += 1
                if img is None:
                    continue  # corrupt frame: skip, keep streaming
                yield (img * 255.0 + 0.5).astype(np.uint8)
    finally:
        loader.close()


def capture_frames(source: str):
    """RGB frames from a camera (``cam``) or a video file, through cv2."""
    import cv2

    cap = cv2.VideoCapture(0 if source == "cam" else source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video source {source!r}")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame[..., ::-1]  # BGR → RGB
    cap.release()


def main(argv=None):
    p = argparse.ArgumentParser(description="PPN streaming video pose")
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ini", default=None, metavar="PATH",
                   help="reference-style config.ini applied over --config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--source", default="synthetic",
                   help="'synthetic', 'cam', a directory of JPEGs, or a "
                        "video file path")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--out", default=None,
                   help="directory for annotated frames (PNG)")
    p.add_argument("--json", action="store_true",
                   help="print latency summary as one JSON line")
    p.add_argument("--no-overlap", action="store_true",
                   help="wait for each frame's poses before sending the "
                        "next frame")
    p.add_argument("--pre-resize", action="store_true",
                   help="downscale each frame to the model input on the "
                        "host before upload (PIL bilinear in the capture "
                        "thread instead of the device resize; last-bit "
                        "differences)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="PATH=VALUE",
                   help="dotted-path config override (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    from ppn_tpu_torch.configs import resolve_config
    from ppn_tpu_torch.inference import Predictor, fetch_async, wait_host

    cfg = resolve_config(args.config, args.ini)
    if args.overrides:
        from ppn_tpu_torch.overrides import apply_overrides

        cfg = apply_overrides(cfg, args.overrides)
    model = Predictor.from_checkpoint(cfg, args.ckpt_dir,
                                      device=args.device).model
    if args.ckpt_dir:
        print(f"loaded {args.ckpt_dir}", file=sys.stderr)
    pipeline = make_video_pipeline(cfg, model, pre_resized=args.pre_resize)

    if args.source == "synthetic":
        frames = synthetic_frames(args.frames)
    elif os.path.isdir(args.source):
        frames = jpeg_frames(args.source, args.frames, cfg.model.insize)
    else:
        frames = capture_frames(args.source)
    if args.pre_resize:
        # runs in the capture thread: the downscale overlaps device work
        frames = (host_resize(f, cfg.model.insize) for f in frames)

    # Warm the pipeline on the first frame before the capture thread
    # starts: the slot below drops stale frames, so a slow first call
    # (cuDNN set-up, the kernel's build and load) would eat the stream.
    import itertools

    frames = iter(frames)
    first = next(frames, None)
    if first is not None:
        wait_host(*fetch_async(pipeline(first)))
        frames = itertools.chain([first], frames)

    # capture thread feeding a latest-frame slot (drop stale frames)
    slot: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=1)
    done = threading.Event()

    def producer():
        for f in frames:
            try:
                slot.get_nowait()          # drop stale
            except queue.Empty:
                pass
            slot.put(f)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    latencies = []
    n = 0
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    def finish(t0, handle, frame):
        """Wait for one frame's poses on the host; record the end-to-end
        latency; draw."""
        nonlocal n
        people = wait_host(*handle)   # poses on the host: end of pipeline
        latencies.append(time.perf_counter() - t0)
        if args.out and n < 8:
            from ppn_tpu_torch.utils.draw import draw_people

            small = frame.astype(np.float32) / 255.0
            # draw in the frame's own coordinates: rescale the boxes
            sx = frame.shape[1] / cfg.model.insize[1]
            sy = frame.shape[0] / cfg.model.insize[0]
            scale = np.array([sx, sy, sx, sy], np.float32)
            people = people._replace(kp_box=people.kp_box * scale)
            draw_people(cfg.model, small, people).save(
                f"{args.out}/frame_{n:04d}.png")
        n += 1

    # Pipelined loop: the main thread only enqueues a frame's work and the
    # copy of its poses to pinned host memory (fetch_async), then goes on
    # to the next frame; the consumer waits for each frame's copy. Frame
    # N+1's upload and compute thus overlap frame N's wait and fetch, and a
    # recorded latency is dispatch → poses on the host, never the wait for
    # the next frame from the source. maxsize=2 is the double buffer: a
    # deeper queue would only add frames in flight ahead of a pipeline
    # slower than its source, each adding a service time of queueing to
    # every latency; the drop-stale slot absorbs the rate mismatch.
    results: queue.Queue = queue.Queue(maxsize=2)
    consumer_error: list = []

    def consumer():
        while True:
            item = results.get()
            if item is None:
                return
            try:
                finish(*item)
            except BaseException as e:  # surface in the main thread
                consumer_error.append(e)
                return

    def put_checked(item):
        """Enqueue without deadlocking if the consumer died mid-run."""
        while True:
            if consumer_error:
                raise consumer_error[0]
            try:
                results.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    ct = threading.Thread(target=consumer, daemon=True)
    ct.start()
    t_start = time.perf_counter()
    while not (done.is_set() and slot.empty()):
        try:
            frame = slot.get(timeout=0.5)
        except queue.Empty:
            continue
        t0 = time.perf_counter()
        handle = fetch_async(pipeline(frame))
        if args.no_overlap:
            finish(t0, handle, frame)
        else:
            put_checked((t0, handle, frame))
    put_checked(None)
    ct.join()
    if consumer_error:
        raise consumer_error[0]
    wall = time.perf_counter() - t_start

    lat = np.asarray(latencies[3:] or latencies)  # skip the first frames
    summary = {
        "frames": n,
        "fps": round(n / wall, 2),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1000, 2),
        "p90_ms": round(float(np.percentile(lat, 90)) * 1000, 2),
    }
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"{n} frames, {summary['fps']} fps, "
              f"p50 {summary['p50_ms']} ms, p90 {summary['p90_ms']} ms")
    return summary


if __name__ == "__main__":
    main()
