#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``ppn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device  — require CUDA; print the card's name and power limit; turn
               TF32 off for matmuls and cuDNN convs;
  2. build   — compile the kernels from the checkout's sources with nvcc
               for sm_90a, one nvcc per source, in parallel:
               ``ppn_post_kernel`` (ppn_tpu_torch/csrc/post.cu),
               ``ppn_warp_kernel`` (ppn_tpu_torch/csrc/warp.cu) and the
               BatchNorm kernels ``ppn_bn_*`` (csrc/batch_norm.cu); beside
               them, g++ builds the native JPEG pool
               (ppn_tpu_torch/native/loader.cc) against the libjpeg-turbo
               in the imported Pillow's ``pillow.libs`` (a missing one
               fails the run: there is no PIL fallback);
  3. post kernel — against its plain PyTorch version on the card:
               tiny_test, mpii_r18_384 at B=1, 2, 4, 8, 16, 32, 128,
               coco_r18_384 at B=32 (its own det 0.15 / nms 0.3) and
               coco_r18_384_crowded at B=128 (every batch and threshold
               set phase 26's suite gives the kernel) on the ``normal``,
               ``sparse``, ``ties`` and ``nan``
               maps (``nan``: 1% of the limb logits and a few proposal
               logits NaN), the edge cases: no proposal above the threshold
               (``empty``), every proposal above it in NMS chains
               (``chain``, MPII and COCO), B=133 (more CTAs than SMs), and
               the NaN window case (``nan_window_case``: one NaN limb logit
               beside its window's winner, so no winner) on all three
               configs; every decision field bitwise equal, float fields
               within 4 ulps (NaN where the other is NaN);
  4. warp kernel — against its plain PyTorch version on the card, bitwise:
               mpii_r18_384 384² at B=32 with matrices drawn by
               ``sample_params`` and at B=6 with the unit tests' six
               matrices, bf16 and f32; tiny_test 64² likewise; the edge
               cases 64×97 (a width no tile divides) at C=1, 3, 4 and 384²
               at B=1; then the training-mode BatchNorm kernels ``ppn_bn_*``
               against their plain version on ResNet-18's maps at 384²
               (B=8, bf16 and f32, each with the activation it folds in):
               the sums within f32 rounding, and given the kernels' sums
               ``y``, ``dx`` and the parameter gradients within one ulp;
               their forward and backward times at the stem's B=128 map (CUDA
               graphs) beside the bytes bound and the plain version's time;
  5. inference path, part 1 — ``Predictor.from_npz`` on the committed MPII
               snapshot, PCKh over the 16-image synthetic protocol at B=8
               (det 0.02, nms 0.45): 0.9921 ± 3e-3 over 378 joints;
  6. inference path, part 2 — uint8 (128, 384, 384, 3) through
               ``Predictor.predict``: warm-up, then the median of 20 calls
               timed with CUDA events; the post kernel's own time (a CUDA
               graph of 50 launches, and back to back through the wrapper
               with the wrapper's host time per call) beside its plain
               version's and its bounds (the whole map, and the bytes this
               input needs), and its stage split from the kernel's
               %globaltimer stamps at B=1 and B=128 on the main-path map and
               on the ``normal`` map;
  7. flip-TTA — ``Predictor.from_npz(..., flip_tta=True)``, PCKh on the same
               protocol: 0.9894 ± 3e-3 over 378 joints (the JAX package's
               TTA on its CPU), one post launch per predict call; then the
               median of 20 B=128 TTA predicts;
  8. evaluation — COCO OKS AP through ``Predictor`` and
               ``eval/runner.evaluate_oks`` on 16 held-out synthetic images
               at B=8, against the JAX package's values on its CPU within
               5e-3: the COCO snapshot (det 0.02, nms 0.6, 2 persons)
               0.945134 over 32 GT, the same with flip-TTA 0.972408, the
               crowd snapshot (5 persons) 0.862841 over 80; two post
               launches each; wall time per evaluated image, cold and warm,
               and its share in predict; then ``apps/evaluate.main
               --metric oks`` on the COCO snapshot, with the thresholds as
               flags and from a config.ini: its JSON equal to the library's
               summary rounded to 4 places;
  9. real-data input — three file sets written under a temporary
               directory from the held-out protocol images
               (``testing.write_mpii_set``/``write_coco_set``): MPII as
               PNG and as JPEG (quality 95), COCO as PNG; ``apps/evaluate.main
               --data mpii|coco`` on each with the committed snapshots: PCKh
               0.976190 ± 3e-3 (PNG) and 0.965608 ± 3e-3 (JPEG) over exactly
               378 joints, OKS AP 0.945134 ± 5e-3 over exactly 32 GT — the
               JAX package's values on the same files on its CPU — two post
               launches each (the JPEGs decode natively, the default);
               PIL's and libjpeg-turbo's versions and the
               sha256 of the JPEGs and PNGs beside the reference's; wall ms
               per evaluated image on the COCO files, cold and warm, and
               the share of decoding; ``apps/train.main --data mpii`` on 64
               training JPEGs (and the 16 held out as the validation
               split) from the snapshot, B=32, 10 steps: the device cache
               used, finite losses, one warp launch per step, ``eval:``
               PCKh from two post launches, the median step time;
               ``apps/video.main --source <directory of JPEGs>``, 32
               frames through the native pool: one post launch per frame
               (the warm-up frame besides), the first frame's People
               through the kernel equal to the plain pipeline's in every
               decision field, fps and p50/p90;
10. B=1 latency — ``predict_single`` on uint8 384² images, p50 and p90 of
               200 calls after warm-up, without and with TTA, and the split
               of one call: upload, forward, post (kernel device time and
               the wrapper's host time), download;
11. server   — ``apps/serve.main`` self-test on the snapshot (64 requests,
               8 client threads, max batch 32, 5 ms window): every request
               bitwise equal to a direct predict at a bucket the server used,
               and one post launch per predict call (warm-up, batches, the
               check's direct predicts);
12. video    — ``apps/video.main`` on 64 synthetic 720p frames at 30 fps
               with the on-device resize, pipelined and with
               ``--no-overlap``: one post launch per frame (the warm-up
               frame besides); the first frame's People through the kernel
               equal to the plain pipeline's (resize, model,
               ``postprocess_batch_plain``) in every decision field;
13. train step, card against CPU — one ``train_step`` of tiny_test in f32
               (TF32 off), augmentation off, from the same parameters on
               both: loss terms within rel 1e-4;
14. training path — mpii_r18_384 at B=32, bf16, augmentation on, 256
               synthetic images in the port's ``DeviceCache``, fine-tuning
               the committed MPII snapshot through ``Trainer.run`` for 30
               steps into a fresh checkpoint directory: finite losses, one
               warp launch per step, a new ``Trainer`` resumes the step and
               the parameters bitwise, ``Trainer.evaluate`` gives PCKh on
               the 16-image protocol through the post kernel;
15. training times — the median step time over 20 steps and the
               CUDA-event times of augment, encode, forward+backward and
               optimizer+EMA over 10 steps;
16. overfit  — mpii_r18_384 from a fresh init on 8 fixed images,
               augmentation off, constant lr 0.007, 60 steps: the mean
               loss_total of the last 10 steps under half the first's;
17. warp kernel times at B=32 bf16 (a CUDA graph of 50 launches, and back
               to back) beside its plain version and its bound; at B=128
               (the suite's configs 3b and 3c) bitwise its plain version,
               and timed likewise;
18. data parallel, one rank — ``Trainer`` on mpii_r18_384 at B=32, bf16,
               augmentation on, constant lr, 10 steps from the snapshot over
               a ``DeviceCache`` on its mesh (``mesh_shape`` (-1,)): as rank
               0 of an NCCL world of one (``multihost.initialize`` from
               MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE) against the same run
               with no process group, bitwise (parameters, BatchNorm
               statistics, EMA, every step's loss terms); one warp launch
               per step; ``Trainer.evaluate`` under the mesh (two post
               launches for the 16 protocol images);
19. data parallel, two ranks — two spawned processes share cuda:0 in a
               gloo world (NCCL refuses two ranks on one device) and run
               mpii_r18_384 at full width from the snapshot, augmentation
               on, against one process on the joined batch: f32 (TF32 off)
               B=8, one step, loss terms within rel 1e-5 and every
               parameter and running statistic within 1e-5·max|p|; then
               bf16 B=32, 5 steps, loss_total within rel 2e-3; one warp
               launch per step and rank; step times per rank beside the
               one process's;
20. export   — ``utils/export.export_pipeline`` of the snapshot at B=8 on
               the card, to bytes and back through ``load_pipeline``, on the
               protocol's first 8 images: ``valid`` equal to
               ``Predictor.predict``'s (the kernel), floats within 4 ulps
               where valid; the medians of 20 calls of each, the artifact's
               size, the export and reload times, and the plain
               post-process with bounded NMS against its early-exit loop;
21. --pretrained — ``apps/train.main --pretrained`` with a torchvision-key
               state dict made at run time from a seeded port ResNet-18:
               the backbone equal to the file before step 1, two finite
               steps;
22. profiling and debug — ``profiling.trace`` of one B=8 predict names
               ``ppn_post_kernel``; ``device_latency_ms`` of the post kernel's
               wrapper at B=1 beside phase 6's CUDA-graph time; a forward on
               a NaN image raises under ``debug.checking()``, naming a
               module, and passes outside it;
23. native decode — PIL's version, its libjpeg-turbo and the
               ``pillow.libs`` library the pool links; the 16 protocol
               images written as MPII JPEGs enlarged 2.5× to 960² (quality
               95; the files' sha256 beside this script's reference, and
               whether the decoded arrays hash the same — a report, since
               another ``-march=native`` host may round otherwise);
               ``apps/evaluate.main --data mpii`` at the default
               ``native_jpeg=True``: PCKh 0.976190 ± 3e-3 over exactly 378
               joints (the JAX package's value on the same files on its
               CPU), two post launches; ``decode_resize`` ms per image
               beside PIL's decode and resize of the same files, and the
               pool's img/s at 4 and 8 workers; ``apps/video.main`` on
               that directory (32 frames through the pool): one post
               launch per frame and the warm-up, the first frame's
               decisions equal to the plain pipeline's, fps;
24. K-step loop — mpii_r18_384, B=32, bf16, augmentation on, constant lr,
               from the snapshot: one ``make_multi_train_step`` call of K=4
               on a cached index block (its first step eager, the rest
               replays of its CUDA graph) against 4 ``train_step`` calls on
               the same block, the whole state and the mean terms bitwise;
               in a profiler trace of a second call, all replays, exactly
               4 ``ppn_warp_kernel`` kernels and 6 ``ppn_bn_*`` kernels per
               BatchNorm layer and step; ms per step of K-step calls and of
               per-step calls, in turns; then at the benchmark's sizes
               (K=8, B=128, ResNet-18 and HRNet-W32 from a seeded init,
               cuDNN deterministic) two calls against 16 ``train_step``
               calls, bitwise, the second call's kernels by trace the same
               as the eager steps', and the peak memory of each;
25. sharded cache — two spawned ranks share cuda:0 in a gloo world: a
               ``DeviceCache(mesh=)`` of the 256 cached images (128 rows
               per rank), its gathered slices bitwise the replicated
               cache's for four global blocks, bytes per rank; a K=2
               ``Trainer`` over it from the snapshot, cuDNN's
               deterministic algorithms on: f32 B=8 one block, its state
               bitwise the same two steps taken one ``train_step`` at a
               time on the replicated cache's slices (and whether two such
               replays with cuDNN's default choice agree, reported),
               and against one process on the same blocks the mean loss
               terms within rel 1e-5 (the state's distance printed: two
               f32 steps, where phase 19 holds one at 1e-5·max|p|); bf16
               B=32 two blocks, loss_total within rel 2e-3 (phase 19's
               tolerances); K warp launches per call and rank;
26. benchmark suite — ``ppn_tpu_torch/bench/suite.main`` in this
               process at the reference's default sizes, one config at a
               time (1, 2, 3, 3b, 3c, 4, 4b, 5, 5p, 6, 7, 7w, then 1 and 2
               again for the spread between runs): each record's value
               finite and positive and its ``card`` this card, no server
               mismatch in 7 and in every 7w point, 4b's ``mfu_pct`` in
               (0, 100], all 96 frames of 6 through the pool, and each
               config's launches of both kernels equal to what its code
               implies (``expected_bench_launches``); then
               ``python -m ppn_tpu_torch.bench.headline`` as a subprocess:
               rc 0, one JSON line with the stated keys, ``mfu_pct`` in
               (0, 100];
27. parity leftovers — ``data/pipeline.make_grain_loader`` over 64
               synthetic mpii_r18_384 images (seed 0), B=32, 5 epochs, at
               4 spawned worker processes and at 0: the 10 batches' sha256
               equal, the loader's img/s at each (worker start included);
               10 ``train_step`` calls (bf16, augmentation on, constant lr)
               from the committed MPII snapshot on the 4-worker batches,
               exactly 10 warp launches, the median step; each step's terms
               through ``MetricLogger(logdir, tensorboard=True)``, the
               event file read back by this script's own TFRecord reader
               (a bitwise CRC-32C, not the writer's): 1 + 10·(terms)
               records, every CRC, ``file_version`` ``brain.Event:2``, each
               event the logged term rounded to f32 under its tag and step
               with the scalars plugin; ``nn.num_params`` of the model
               equal to the JAX package's count for mpii_r18_384, which
               tests/test_torch_leftovers.py pins;
28. model family — the rest of the JAX package's models at full width:
               ``ppn_post_kernel`` against its plain version on
               mpii_r18_224_fast's 7×7 grid (B=1, 32, 128 on the seeded
               kinds, ``empty``, ``chain``, the NaN window case; phase 3's
               limits) and ``ppn_warp_kernel`` bitwise at 224², B=32, bf16
               and f32, each timed (CUDA graph) against its bound beside
               phases 6 and 17; the eval forwards of mpii_r50_384,
               mpii_r18_384 with ``backbone="resnet34"`` and
               mpii_r18_224_fast on the card against the port's CPU path
               (same seeded weights, B=2): bf16 within 3e-2 and f32 within
               1e-4 of the largest logit; mpii_r50_384 ``Predictor.predict``
               on uint8 (128, 384, 384, 3), the median img/s of 20 calls,
               ``forward_flops`` and ``mfu_pct``, one post launch a call;
               ``apps/train.main`` on an MPII JPEG tree (32 training images,
               16 held out) for mpii_r50_384 and for ``--backbone
               resnet34``, B=32, bf16, augmentation on, 10 steps: finite
               losses, 10 warp launches, the ``eval:`` line from 2 post
               launches, the median step; one f32 mpii_r50_384 step on the
               card against the CPU step from the same state (loss terms
               within rel 1e-4, grad_norm within rel 1e-3; the gradients
               and the updated state printed), ``sgd_update`` from the
               same state on the same seeded gradients (1e-6 of each
               tensor's largest value), two Bottleneck blocks in f32
               training mode against the CPU (output and gradients within
               2e-5, statistics 1e-5 of each tensor's largest value); a
               ResNet-50 overfit of phase 16's 8 images
               from a fresh init (the loss halves in 60 steps), kept as a
               checkpoint for phase 29; ``--pretrained`` with a seeded
               torchvision-layout ResNet-50 (phase 21's checks);
               ``apps/video.main --config mpii_r18_224_fast`` (a seeded
               init) on 64 synthetic 720p frames at 30 fps: the first
               frame's decisions equal to the plain pipeline's, one post
               launch per frame and the warm-up; the phase's time;
29. accuracy tools — ``tools/torch_oracle_ceiling.py`` (mpii_r18_384, 64
               images, 2 persons), ``torch_threshold_sweep.py`` (the MPII
               snapshot, 64 images, det 0.10/0.15/0.20 × nms 0.30/0.45,
               without and with ``--flip-tta``) and
               ``torch_crowding_study.py`` (the crowd snapshot on
               coco_r18_384, protocols 1, 3, 6 and 0 at 32 images, nms
               0.3/0.45/0.6) through their ``main`` on the card, against
               the JAX package's values on its CPU at the same arguments
               (``TOOL_PINS``): oracle ceilings, collision bounds and
               lost-person fractions equal to their printed decimals; each
               model tool run in bf16 and in f32, every f32 point within
               3e-3 of the JAX package's f32 value and every bf16 point
               within 3e-3 of its bf16 value, but for the points named in
               ``TOOL_BF16_MISSES`` (within the JAX package's own
               bf16-to-f32 gap); post launches as the code implies (one
               per point and map set); ``torch_export_snapshot.py`` of
               phase 28's overfit checkpoint, reloaded by
               ``Predictor.from_npz``: its logits finite and bitwise those
               of the in-memory eval model with parameters and statistics
               rounded through f16 (cuDNN's deterministic algorithms); the
               phase's time;
30. stage profilers — checks first, on fresh models under cuDNN's
               deterministic algorithms: ``tools/torch_bwd_split.py``'s
               stages (split at the cumulative ``stage_sizes``) composed
               bitwise ``backbone(x)`` on ResNet-18, -34 and -50 in
               channels_last, ``torch_fwd_split.py``'s ingest ∘ blocks ∘
               head bitwise ``model(img)``, its s2d stem within 3e-2 of
               the largest value of the 7×7 stem; then each tool through
               its ``main`` at ``SPLIT_ITERS``: the train split on
               mpii_r18_384 at B=32 (every variant; ``full_body`` is
               ``train_step`` on a copy of the state), bwd_split on
               ResNet-18 at B=32 and 128 with its 21 BatchNorm layers
               also timed alone, and on ResNet-34 and -50 at B=32,
               fwd_split at B=128 with the s2d A/B; ``ppn_warp_kernel``
               launches equal to what the train split's calls imply
               (``split_warp_launches``), none elsewhere, no post launch;
               the phase's time;
31. report  — the serving, evaluation, file-input, ninth, eleventh,
               benchmark, parity-leftover, model-family, tool and
               profiler numbers, the kernels line, then the device line
               last.

Launch counts are set to 0 just before each path (phase 5 for inference,
7 for TTA, 8 for each evaluation and CLI run, 9 for each CLI run on files,
10 for B=1, 11 for the server, 12 for video, 14 for training, 18 for each
one-rank run and its evaluation, 19 in each rank and in the one process
before its steps, 20 before the exported call, 23 before the evaluate and
video CLIs, 24 before the K-step call, 25 in each rank and in the one
process before its Trainer runs, 26 before each suite config, 27 before
its steps, 28 before the ResNet-50 predicts, each train CLI and the video
CLI, 29 and 30 before each tool run) and read just after it; comparison
and timing launches fall outside those windows.
"""

from __future__ import annotations

import contextlib
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
PINNED_PCKH, PINNED_JOINTS = 0.9921, 378
# flip-TTA on the same protocol: the JAX package's value on its CPU
# (train/steps.make_forward(flip_tta=True) through eval/runner.evaluate_pckh)
PINNED_TTA_PCKH = 0.98942
LATENCY_CALLS = 200
VIDEO_FRAMES = 64
ULP_LIMIT = 4   # σ and box floats: same formula on both sides, so 0 is
                # expected; 4 leaves room for a different expf rounding
DECISIONS = ("kp_cell", "kp_valid", "valid", "num_kp")
FLOATS = ("kp_box", "kp_score")
TRAIN_STEPS = 30
TRAIN_IMAGES = 256
OVERFIT_STEPS = 60
DP_STEPS = 10            # phase 18: one rank against no group, bitwise
DP_BF16_STEPS = 5        # phase 19: two ranks against one process, bf16
ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz")
COCO_SNAPSHOT = os.path.join(ROOT, "artifacts", "coco_hero_r3_ema_f16.npz")
CROWD_SNAPSHOT = os.path.join(ROOT, "artifacts", "crowd_hero_r5_ema_f16.npz")
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
K_STEPS = 4              # phase 24: steps per K-step call
# phase 24 at the benchmark's sizes: the configs, batch and steps per call
GRAPH_CONFIGS, GRAPH_B, GRAPH_K = ("mpii_r18_384", "mpii_hrw32_384"), 128, 8
# phase 24: the kernels counted by name in a profiler trace of a call
GRAPH_KERNELS = ("ppn_warp_kernel", "ppn_bn_")
SHARDED_BLOCKS = 4       # phase 25: global blocks gathered and compared
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
# (angle, scale, tx, flip): the warp cases of tests/test_pallas_warp.py
WARP_CASES = [(0.0, 1.0, 0.0, False), (0.3, 1.1, 12.0, False),
              (-0.5, 0.8, -7.0, False), (0.7, 1.25, 3.0, True),
              (0.69, 3.9, 50.0, False), (-0.69, 0.26, -120.0, True)]
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
# to 16% of their largest value (the phase prints both; PERF.md),
# so the step's gradients and updated state are printed, not held. What is
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


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's ``nvidia-smi`` name and power limit line."""
    from ppn_tpu_torch.bench.suite import card

    return card("cuda")


def compare(got, want) -> tuple[bool, int, float]:
    """(decisions bitwise equal, max ulp, max abs error) of two People."""
    from ppn_tpu_torch.testing import max_ulp

    equal = all(torch.equal(getattr(got, f), getattr(want, f))
                for f in DECISIONS)
    ulp, err = 0, 0.0
    for f in FLOATS:
        g, w = getattr(got, f).cpu().numpy(), getattr(want, f).cpu().numpy()
        ulp = max(ulp, max_ulp(g, w))       # a lone NaN counts as 2**32
        d = np.abs(g - w)
        err = max(err, float(np.where(np.isnan(d), 0.0, d).max(initial=0.0)))
    return equal, ulp, err


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call with `reps` calls captured in a CUDA
    graph and replayed: each kernel and its launch, without the host's
    per-call Python work (which bounds `time_ms` for a kernel of a few tens
    of µs)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int) -> float:
    """Median over `reps` single calls of the CUDA-event time around one
    call (for a call the host cannot keep ahead of, its enqueue time)."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def percentiles_ms(fn, calls: int) -> tuple[float, float]:
    """p50 and p90 of the host-clock time of `calls` calls of `fn`, each
    ending with its results on the host."""
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        lat.append(1e3 * (time.perf_counter() - t0))
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 90)))


def quiet_call(fn, *args):
    """fn(*args) with its standard output captured: (result, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def host_us(fn, reps: int) -> float:
    """Mean host time of one call over `reps` calls enqueued back to back
    (µs; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


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


def train_stage_ms(cfg, state, batch, steps: int) -> dict:
    """Mean CUDA-event times (ms) of the stages of ``train_step`` over
    `steps` steps: the same calls as ``steps.loss_and_grads`` and
    ``steps.sgd_update``, with events between them."""
    from ppn_tpu_torch.ops.augment import augment_batch
    from ppn_tpu_torch.ops.encode import encode_batch
    from ppn_tpu_torch.train.loss import ppn_loss
    from ppn_tpu_torch.train.steps import sgd_update

    m, dev = cfg.model, state.device
    model = state.model.train()
    names, params = zip(*model.named_parameters())
    sums = [0.0] * 4
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        b = augment_batch(m, cfg.data, state.generator, batch, device=dev)
        ev[1].record()
        t = encode_batch(m, b["keypoints"], b["visible"], b["bboxes"],
                         b["valid"])
        ev[2].record()
        _, terms = ppn_loss(m, model(b["image"]), t)
        grads = dict(zip(names, torch.autograd.grad(terms["loss_total"],
                                                    params)))
        ev[3].record()
        sgd_update(cfg, state, grads)
        ev[4].record()
        torch.cuda.synchronize()
        for i in range(4):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    return dict(zip(("augment", "encode", "forward_backward",
                     "optimizer_ema"), (s / steps for s in sums)))


def free_port() -> int:
    """A TCP port on the loopback address that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def constant_lr(cfg, **train):
    """``cfg`` with a constant learning rate from the first step (the
    config's rate, no warmup: the default warmup starts at lr 0, which
    would leave the first step's parameters where they were)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_schedule="constant", warmup_steps=0, **train))


def dp_one_rank(cfg, train_ds, val, dev) -> dict:
    """Phase 18: ``Trainer`` runs of DP_STEPS steps from the snapshot, with
    no process group and then as rank 0 of a world of one over NCCL
    (``multihost.initialize`` from the launcher's environment), each over
    a ``DeviceCache`` on its mesh. Returns each run's state, EMA, per-step
    loss terms and warp launches, and the NCCL run's PCKh and post
    launches of ``Trainer.evaluate``."""
    import torch.distributed as dist

    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.parallel import make_mesh
    from ppn_tpu_torch.parallel.multihost import initialize
    from ppn_tpu_torch.train.trainer import Trainer

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1"}
    runs = {}
    for label in ("no_group", "nccl"):
        d = tempfile.mkdtemp(prefix="dp1_", dir=os.path.join(ROOT, "build"))
        try:
            if label == "nccl":
                os.environ.update(env)
                initialize()
                if (dist.get_backend() != "nccl"
                        or dist.get_world_size() != 1):
                    raise AssertionError("the launcher's world did not join "
                                         "NCCL with one rank")
            mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, dev)
            batches = DeviceCache(train_ds, device=dev, mesh=mesh
                                  ).infinite_batches(cfg.train.batch_size,
                                                     seed=0)
            tcfg = constant_lr(cfg, checkpoint_dir=d, log_every=1,
                               checkpoint_every=0, eval_every=0, resume=False)
            cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
            trainer, _ = quiet_call(functools.partial(
                Trainer, tcfg, batches, val_dataset=val, logdir=d,
                init_npz=SNAPSHOT, device=dev, mesh=mesh))
            quiet_call(trainer.run, DP_STEPS)
            torch.cuda.synchronize()
            run = {"warp": cuda_warp.LAUNCHES,
                   "state": trainer.state.model.state_dict(),
                   "ema": trainer.state.ema}
            if label == "nccl":
                run["pckh"] = trainer.evaluate(max_images=16, batch_size=8)
                run["post"] = cuda_post.LAUNCHES
            with open(os.path.join(d, "train_metrics.jsonl")) as fh:
                run["terms"] = [{k: v for k, v in json.loads(line).items()
                                 if k.startswith("loss_") or k == "grad_norm"}
                                for line in fh]
            trainer.close()
            runs[label] = run
        finally:
            shutil.rmtree(d, ignore_errors=True)
            if label == "nccl":
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k in env:
                    os.environ.pop(k, None)
    return runs


def dp_steps(cases: dict, mesh) -> dict:
    """For each case (label → (config, global batches on the host)): a train
    state from the snapshot, replicated over ``mesh``, takes one
    ``train_step`` with augmentation per batch on this rank's slice of it.
    Returns, by label, the loss terms of each step, each step's host ms
    (the device synchronized on both sides), the warp launches and the
    state after (on the host)."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.parallel import replicate, shard_batch
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    out = {}
    for label, (cfg, batches) in cases.items():
        state = st.create_train_state(cfg, device=mesh.device)
        load_npz_into_train_state(cfg, SNAPSHOT, state)
        replicate(mesh, state)
        cuda_warp.LAUNCHES = 0
        terms, ms = [], []
        for batch in batches:
            local = shard_batch(mesh, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = st.train_step(cfg, state, local, augment=True, mesh=mesh)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            terms.append({k: float(v) for k, v in t.items()})
        out[label] = {"terms": terms, "ms": ms,
                      "launches": cuda_warp.LAUNCHES,
                      "state": {k: v.cpu() for k, v in
                                state.model.state_dict().items()}}
    return out


def dp_rank(rank: int, world: int, port: int, outdir: str,
            cases: dict) -> None:
    """Phase 19's ranks: each joins a gloo world on the loopback address
    (NCCL refuses two ranks on one device), computes on cuda:0 with TF32
    off, and writes ``dp_steps``' results to ``<outdir>/rank<r>.pt``."""
    import torch.distributed as dist

    from ppn_tpu_torch.parallel import make_mesh
    from ppn_tpu_torch.parallel.multihost import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        out = dp_steps(cases, make_mesh(device="cuda:0"))
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def max_rel_state(got: dict, want: dict) -> tuple[float, str]:
    """The worst |got − want| / max|want| over the tensors of a state, and
    its tensor."""
    return max((float((got[k].float() - want[k].float()).abs().max())
                / max(float(want[k].float().abs().max()), 1e-30), k)
               for k in want)


def export_phase(cfg, val, dev) -> dict:
    """Phase 20: the pipeline exported at B=8 on the card, to bytes and back,
    on the first 8 images of the synthetic protocol, against
    ``Predictor.predict`` (the post kernel) on the same images; times of
    both, of the export and the reload, and of the plain post-process's
    bounded NMS against its early-exit loop on the model's map."""
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import max_ulp
    from ppn_tpu_torch.utils.export import export_pipeline, load_pipeline

    B = 8
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
    return {"valid_equal": equal, "max_ulp": ulp,
            "persons": int(want.valid.sum()), "bytes": len(blob),
            "export_s": t1 - t0, "load_s": t2 - t1,
            "exported_ms_b8": exp_ms, "predict_ms_b8": pred_ms,
            "post_launches_exported": exported_launches,
            "plain_post_bounded_ms_b8": bounded_ms,
            "plain_post_early_exit_ms_b8": early_ms}


def timed(fn) -> float:
    """Host seconds of one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def pretrained_phase(name: str = "mpii_r18_384") -> dict:
    """Phase 21 (and phase 28 for ``mpii_r50_384``): ``apps/train.main
    --pretrained`` on the card with a torchvision-key state dict made at
    run time from a seeded port backbone of the config's kind (with the
    ``fc`` and ``num_batches_tracked`` entries torchvision files carry,
    which the loader drops). ``--steps 0`` writes the state before the
    first step, whose backbone must equal the file; ``--steps 2`` then
    resumes from it and must log finite losses."""
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
    d = tempfile.mkdtemp(prefix="pretrained_", dir=os.path.join(ROOT, "build"))
    try:
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
        with open(os.path.join(d, "train_metrics.jsonl")) as fh:
            losses = [json.loads(line)["loss_total"] for line in fh]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"tensors": len(got), "equal_before_step_1": exact,
            "losses": losses}


def profiling_phase(cfg, val, dev) -> dict:
    """Phase 22: ``profiling.trace`` around one B=8 ``Predictor.predict``
    (the trace must name ``ppn_post_kernel``), ``device_latency_ms`` of the
    post-process at B=1 on the snapshot's map (200 and 400 calls, the min of
    5 runs each) beside the wrapper's host time, and a forward on a NaN image
    under ``debug.checking()`` (must raise, naming a module) and outside it
    (must not)."""
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.utils import debug, profiling

    pred = Predictor.from_npz(cfg, SNAPSHOT)
    images = np.stack([val[i]["image"] for i in range(8)])
    pred.predict(images)
    d = tempfile.mkdtemp(prefix="trace_", dir=os.path.join(ROOT, "build"))
    try:
        with profiling.trace(d, device=dev):
            pred.predict(images)
        with open(os.path.join(d, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
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
    return {"kernels_in_trace": len(kernels), "post_in_trace": len(post),
            "post_trace_us": sum(e.get("dur", 0) for e in post),
            "post_device_latency_ms_b1": latency,
            "post_wrapper_host_us_b1": wrapper_us,
            "nan_passes_unchecked": unchecked, "checking_raised": raised}


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


def file_input_phase(model, card: str) -> dict:
    """Phase 9: the evaluate, train and video CLIs on files on the card.
    ``model`` is the MPII snapshot's eval model, for the first video
    frame's plain pipeline."""
    import ast
    import re

    import PIL
    from PIL import features

    from ppn_tpu_torch.apps import evaluate, train, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.coco import make_coco_datasets
    from ppn_tpu_torch.eval.runner import evaluate_oks
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import resize_bilinear
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain

    out = {}
    d = tempfile.mkdtemp(prefix="files_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
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
        log(f"[files] sets written in {time.perf_counter() - t0:.1f} s; "
            f"here PIL {origin['pil']}, libjpeg-turbo "
            f"{origin['libjpeg_turbo']}, sha256 of the 16 JPEGs "
            f"{origin['mpii_jpg']}, of the 16 PNGs {origin['mpii_png']}; "
            f"where the pins were taken PIL {FILE_SET_ORIGIN['pil']}, "
            f"libjpeg-turbo {FILE_SET_ORIGIN['libjpeg_turbo']}, "
            f"{FILE_SET_ORIGIN['mpii_jpg']}, {FILE_SET_ORIGIN['mpii_png']}; "
            f"equal: {out['same_as_reference']}")

        # 1-3: the evaluate CLI on each set
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
            log(f"[files] evaluate CLI --data {data} on {label}: {metric} "
                f"{value} (pinned {pin} ± {tol}), {summary[key]:.0f} "
                f"{key.split('/')[1]}; ppn_post_kernel launches {launches}; "
                f"{wall:.2f} s with the snapshot's load | {card}")
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
        in_predict = []

        def timed_predict(images):
            t0 = time.perf_counter()
            people = cpred.predict(images)
            in_predict.append(time.perf_counter() - t0)
            return people

        passes = []
        for _ in range(2):              # cold, then warm
            in_predict.clear()
            t0 = time.perf_counter()
            ap = evaluate_oks(ccfg, timed_predict, cval, max_images=16,
                              batch_size=8)["oks/AP"]
            passes.append((time.perf_counter() - t0, sum(in_predict)))
        t0 = time.perf_counter()
        for i in range(16):
            cval[i]
        decode_s = time.perf_counter() - t0
        out["coco_png"]["ap_unrounded"] = ap
        out["coco_timing"] = {
            "cold_ms_per_image": 1e3 * passes[0][0] / 16,
            "cold_predict_ms_per_image": 1e3 * passes[0][1] / 16,
            "warm_ms_per_image": 1e3 * passes[1][0] / 16,
            "warm_predict_ms_per_image": 1e3 * passes[1][1] / 16,
            "decode_ms_per_image": 1e3 * decode_s / 16}
        log("[files] COCO PNG files, B=8, ms per evaluated image: "
            + ", ".join(f"{k} {v:.3f}" for k, v in out["coco_timing"].items())
            + f" (decode: the 16 samples read alone); OKS AP unrounded "
            f"{ap:.6f} | {card}")
        del cpred

        # 4: training on files
        ck = os.path.join(d, "ckpt")
        cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        _, printed = quiet_call(train.main, [
            "--config", "mpii_r18_384", "--data", "mpii", "--data-root",
            roots["mpii_train_jpg"], "--init-npz", SNAPSHOT, "--batch-size",
            "32", "--steps", str(FILE_TRAIN_STEPS), "--no-resume",
            "--ckpt-dir", ck, "--log-dir", ck, "--set", "train.log_every=1"])
        wall = time.perf_counter() - t0
        warp, post = cuda_warp.LAUNCHES, cuda_post.LAUNCHES
        with open(os.path.join(ck, "train_metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        losses = [r["loss_total"] for r in logged if "loss_total" in r]
        step_ms = [1e3 * 32 / r["images_per_sec"] for r in logged
                   if "images_per_sec" in r]
        # the printed dict's values may be numpy scalars: np.float64(0.97)
        evals = [ast.literal_eval(re.sub(r"np\.\w+\(", "(",
                                         line[len("eval: "):]))
                 for line in printed.splitlines() if line.startswith("eval:")]
        cached = f"device cache: {FILE_TRAIN_IMAGES} samples" in printed
        out["train"] = {
            "device_cache": cached, "losses": losses, "warp_launches": warp,
            "post_launches": post, "eval": evals[0] if evals else None,
            "step_ms_median": statistics.median(step_ms), "cli_s": wall}
        log(f"[files] train CLI --data mpii on {FILE_TRAIN_IMAGES} JPEGs, "
            f"B=32, {FILE_TRAIN_STEPS} steps from the snapshot: device cache"
            f" {cached}; loss_total {[round(v, 4) for v in losses]}; "
            f"ppn_warp_kernel launches {warp}; eval {out['train']['eval']} "
            f"from {post} ppn_post_kernel launches; median step "
            f"{out['train']['step_ms_median']:.3f} ms (host clock between "
            f"the trainer's per-step logs; {wall:.1f} s with decoding and "
            f"set-up) | {card}")
        if (not cached or len(losses) != FILE_TRAIN_STEPS
                or not all(math.isfinite(v) for v in losses)
                or warp != FILE_TRAIN_STEPS or post != 2 or len(evals) != 1
                or not math.isfinite(evals[0]["pckh/mean"])):
            raise AssertionError(f"training on files: {out['train']}")

        # 5: video from a directory of JPEGs
        frames_dir = os.path.join(roots["mpii_jpg"], "images")
        vcfg = get_config("mpii_r18_384")    # the video app's thresholds
        frame0 = next(video.jpeg_frames(frames_dir, 1, vcfg.model.insize))
        got = video.make_video_pipeline(vcfg, model)(frame0)
        with torch.no_grad():
            img = resize_bilinear(torch.from_numpy(frame0).to(
                next(model.parameters()).device).float() / 255.0,
                vcfg.model.insize)
            want = postprocess_batch_plain(vcfg.model, model(img[None]))
        want = type(want)(*(t[0] for t in want))
        equal, ulp, _ = compare(got, want)
        cuda_post.LAUNCHES = 0
        summary, _ = quiet_call(video.main, [
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            frames_dir, "--frames", str(FILE_VIDEO_FRAMES), "--json"])
        summary["launches"] = cuda_post.LAUNCHES
        out["video"] = dict(summary, first_frame_decisions_equal=equal,
                            first_frame_max_ulp=ulp)
        log(f"[files] video CLI --source <16 JPEGs>, {FILE_VIDEO_FRAMES} "
            f"frames: {json.dumps(summary)} (launches include the warm-up "
            f"frame); first frame against the plain pipeline: "
            f"decisions_equal={equal} max_ulp={ulp} persons "
            f"{int(want.valid.sum())} | {card}")
        if (not equal or ulp > ULP_LIMIT
                or summary["launches"] != summary["frames"] + 1):
            raise AssertionError(f"video from a directory: {out['video']}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def native_phase(model, card: str) -> dict:
    """Phase 23: the native JPEG pool on enlarged protocol JPEGs: the
    evaluate CLI at its default decoding, decode times beside PIL's, the
    pool's rate, and the video CLI on the directory. ``model`` is the MPII
    snapshot's eval model, for the first video frame's plain pipeline."""
    import hashlib

    import PIL
    from PIL import features

    from ppn_tpu_torch.apps import evaluate, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.imageio import load_resized
    from ppn_tpu_torch.data.synthetic import heldout_dataset
    from ppn_tpu_torch.native import loader as nl
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.image import resize_bilinear
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import write_mpii_set

    cfg = get_config("mpii_r18_384")
    hw = cfg.model.insize
    out = {"pil": PIL.__version__,
           "libjpeg_turbo": features.version("libjpeg_turbo"),
           "pillow_libjpeg": str(nl.libjpeg())}
    d = tempfile.mkdtemp(prefix="native_", dir=os.path.join(ROOT, "build"))
    try:
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
        same = {k: out[k] == NATIVE_SET_ORIGIN[k] for k in NATIVE_SET_ORIGIN}
        out["same_as_reference"] = same
        log(f"[native] PIL {out['pil']}, libjpeg-turbo "
            f"{out['libjpeg_turbo']}, the pool links {out['pillow_libjpeg']}"
            f"; 16 JPEGs at {out['dims'][0]}x{out['dims'][1]} sha256 "
            f"{out['files']}, decoded at 384² sha256 {out['decoded']}; "
            f"where the pin was taken: PIL {NATIVE_SET_ORIGIN['pil']}, "
            f"libjpeg-turbo {NATIVE_SET_ORIGIN['libjpeg_turbo']}, "
            f"{NATIVE_SET_ORIGIN['files']}, {NATIVE_SET_ORIGIN['decoded']}; "
            f"equal (a report, not a check): {same}")

        # the evaluate CLI at its default decoding (native for JPEGs)
        pin, joints = NATIVE_PIN
        cuda_post.LAUNCHES = 0
        summary, _ = quiet_call(evaluate.main, [
            "--config", "mpii_r18_384", "--data", "mpii", "--data-root", d,
            "--ckpt-dir", SNAPSHOT, "--max-images", "16", "--batch-size",
            "8", "--detection-thresh", "0.02", "--nms-thresh", "0.45"])
        launches = cuda_post.LAUNCHES
        out["evaluate"] = dict(summary, launches=launches, pinned=pin)
        log(f"[native] evaluate CLI --data mpii on the 960² JPEGs, native "
            f"decoding: PCKh {summary['pckh/mean']} (pinned {pin} ± 3e-3), "
            f"{summary['pckh/num_joints']:.0f} joints; ppn_post_kernel "
            f"launches {launches} | {card}")
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
        log(f"[native] 960² JPEG -> 384² float32 RGB, ms per image (median "
            f"of 3 passes over the 16 files, one host thread): "
            f"decode_resize {out['decode_ms']['native']:.3f}, PIL decode and "
            f"resize {out['decode_ms']['pil']:.3f}; pool, {POOL_JOBS} images:"
            f" {rates[4]:.1f} img/s at 4 workers, {rates[8]:.1f} at 8 | "
            f"{card} | {os.cpu_count()} host cores")

        # video from the directory through the pool
        vcfg = get_config("mpii_r18_384")
        frame0 = next(video.jpeg_frames(images, 1, vcfg.model.insize))
        got = video.make_video_pipeline(vcfg, model)(frame0)
        with torch.no_grad():
            img = resize_bilinear(torch.from_numpy(frame0).to(
                next(model.parameters()).device).float() / 255.0,
                vcfg.model.insize)
            want = postprocess_batch_plain(vcfg.model, model(img[None]))
        want = type(want)(*(t[0] for t in want))
        equal, ulp, _ = compare(got, want)
        cuda_post.LAUNCHES = 0
        summary, _ = quiet_call(video.main, [
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            images, "--frames", str(FILE_VIDEO_FRAMES), "--json"])
        summary["launches"] = cuda_post.LAUNCHES
        out["video"] = dict(summary, first_frame_decisions_equal=equal,
                            first_frame_max_ulp=ulp)
        log(f"[native] video CLI --source <16 JPEGs at 960²> through the "
            f"pool, {FILE_VIDEO_FRAMES} frames: {json.dumps(summary)} "
            f"(launches include the warm-up frame); first frame against the "
            f"plain pipeline: decisions_equal={equal} max_ulp={ulp} | {card}")
        if (not equal or ulp > ULP_LIMIT
                or summary["launches"] != summary["frames"] + 1):
            raise AssertionError(f"video through the pool: {out['video']}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def same_state(a, b) -> bool:
    """Whether two train states are bitwise equal: parameters, BatchNorm
    statistics, momentum traces, EMA, step and generator."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step
            and all(torch.equal(v, sb[k]) for k, v in sa.items())
            and all(torch.equal(v, b.trace[k]) for k, v in a.trace.items())
            and (a.ema is None) == (b.ema is None)
            and all(torch.equal(v, b.ema[k]) for k, v in (a.ema or {}).items())
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def bn_case(B: int, C: int, side: int, dtype, dev, seed: int = 0):
    """A channels_last (B, C, side, side) map with channels of their own
    mean and spread, scale and bias, and an upstream gradient."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    shift, spread = randn(C), randn(C).abs() + 0.5
    x = (randn(B, side, side, C) * spread + shift).to(dtype).permute(0, 3, 1, 2)
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


def bn_phase(dev, card: str) -> dict:
    """Phase 4, BatchNorm: ``ppn_bn_*`` against the plain version on
    ``BN_CASES``, then timed at the stem's B=128 map, beside PyTorch's
    SyncBatchNorm primitives and a ReLU on the same map."""
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
    # times at the stem's map, B=128 bf16 with its ReLU
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
    out = {"worst": worst, "ms_forward": f_ms, "ms_backward": b_ms,
           "bound_ms_forward": f_bound, "bound_ms_backward": b_bound,
           "ms_layer_eager": layer_ms, "plain_ms": plain_ms,
           "library_ms": lib_f_ms + lib_b_ms,
           "library_ms_forward": lib_f_ms, "library_ms_backward": lib_b_ms}
    log(f"[time] BatchNorm at the stem's map, B=128 64x192x192 bf16 + ReLU: "
        f"ppn_bn_* forward {f_ms:.4f} ms (bound {f_bound:.4f}: x read twice, "
        f"y written), backward {b_ms:.4f} ms (bound {b_bound:.4f}: dy and x "
        f"read twice, dx written), CUDA graphs of 20 calls; PyTorch's "
        f"SyncBatchNorm primitives with a separate ReLU forward "
        f"{lib_f_ms:.4f} ms, backward {lib_b_ms:.4f} ms, the same way; the "
        f"layer's forward+backward through autograd back to back "
        f"{layer_ms:.4f} ms; plain {plain_ms:.3f} ms | {card}")
    return out


def k_step_phase(cfg, cache, dev, card: str) -> dict:
    """Phase 24: one K-step call against K ``train_step`` calls on the same
    block, bitwise; the ``ppn_warp_kernel`` and ``ppn_bn_*`` kernels that a
    second call, whose steps all replay its CUDA graph, runs by a profiler
    trace; then ms per step of both, in turns."""
    from ppn_tpu_torch.nn.resnet import BatchNorm
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state
    from ppn_tpu_torch.utils.profiling import kernel_records

    kcfg = constant_lr(cfg, steps_per_call=K_STEPS)
    B = kcfg.train.batch_size
    a, b = (load_npz_into_train_state(
        kcfg, SNAPSHOT, st.create_train_state(kcfg, device=dev))
        for _ in range(2))
    rng = np.random.default_rng(24)

    def block():
        return np.stack([rng.choice(TRAIN_IMAGES, B, replace=False)
                         for _ in range(K_STEPS)]).astype(np.int32)

    idx = block()
    multi = st.make_multi_train_step(kcfg, augment=True,
                                     steps_per_call=K_STEPS)
    per = [st.train_step(kcfg, b, cache.batch(i), augment=True) for i in idx]
    torch.cuda.synchronize()
    got = multi(a, cache, idx)
    torch.cuda.synchronize()
    bn_layers = sum(isinstance(m, BatchNorm) for m in a.model.modules())
    mean = {k: torch.stack([t[k] for t in per]).mean(0) for k in per[0]}
    terms_equal = got.keys() == mean.keys() and all(
        torch.equal(v, mean[k]) for k, v in got.items())
    state_equal = same_state(a, b)
    _, records = kernel_records(multi, a, cache, block(), device=dev,
                                names=GRAPH_KERNELS)
    launches, bn_launches = (records[n] for n in GRAPH_KERNELS)
    k_ms, s_ms = [], []
    for _ in range(4):                  # in turns: K-step, per-step
        for label, ms in (("k", k_ms), ("s", s_ms)):
            i = block()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "k":
                multi(a, cache, i)
            else:
                for row in i:
                    st.train_step(kcfg, b, cache.batch(row), augment=True)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / K_STEPS)
    out = {"state_equal": state_equal, "terms_equal": terms_equal,
           "warp_launches_per_call": launches,
           "bn_launches_per_call": bn_launches, "bn_layers": bn_layers,
           "loss_total": float(got["loss_total"]),
           "k_step_ms_per_step": statistics.median(k_ms),
           "per_step_ms_per_step": statistics.median(s_ms),
           "k_step_ms_all": k_ms, "per_step_ms_all": s_ms}
    log(f"[kstep] K={K_STEPS} B={B} bf16 with augmentation from the "
        f"snapshot: one make_multi_train_step call against {K_STEPS} "
        f"train_step calls on the same block, state bitwise {state_equal}, "
        f"mean terms bitwise {terms_equal} (loss_total "
        f"{out['loss_total']:.6f}); in a profiler trace of a second call, "
        f"all replays, ppn_warp_kernel kernels {launches}, ppn_bn_* kernels "
        f"{bn_launches} ({bn_layers} BatchNorm layers); ms per step (host "
        f"clock around synchronized blocks of {K_STEPS} steps, median of 4 "
        f"in turns): K-step "
        f"{out['k_step_ms_per_step']:.3f}, per-step "
        f"{out['per_step_ms_per_step']:.3f} | {card}")
    if (not state_equal or not terms_equal or launches != K_STEPS
            or bn_launches != 6 * bn_layers * K_STEPS):
        raise AssertionError(f"K-step loop: {out}")
    del multi, a, b
    torch.cuda.empty_cache()
    out["bench_sizes"] = {name: k_step_graph_case(name, cache, dev, card)
                          for name in GRAPH_CONFIGS}
    return out


def k_step_graph_case(name: str, cache, dev, card: str) -> dict:
    """Phase 24 at the benchmark's sizes: two K=8 calls of B=128 on a seeded
    ``name`` state (the first's first step eager, then a CUDA graph
    captured and replayed for the other fifteen steps) against 16
    ``train_step`` calls of a twin on the same blocks: the whole state and
    each call's mean terms bitwise; the ``ppn_warp_kernel`` and
    ``ppn_bn_*`` kernels of the second call, all replays, by a profiler
    trace against those of the eager steps on its block; the peak memory
    of each. cuDNN is held to its deterministic algorithms, so that eager
    steps are bitwise each other at this size."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.profiling import kernel_records

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=GRAPH_B, steps_per_call=GRAPH_K))
    rng = np.random.default_rng(2401)
    blocks = [np.stack([rng.choice(TRAIN_IMAGES, GRAPH_B, replace=False)
                        for _ in range(GRAPH_K)]).astype(np.int32)
              for _ in range(2)]

    def eager_call(state, idx):
        per = [st.train_step(cfg, state, cache.batch(i), augment=True)
               for i in idx]
        return {k: torch.stack([t[k] for t in per]).mean(0) for k in per[0]}

    def counters():
        return [st.EAGER_STEPS, st.GRAPH_CAPTURES, st.GRAPH_REPLAYS]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        b = st.create_train_state(cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        want = [eager_call(b, blocks[0])]
        out, eager = kernel_records(eager_call, b, blocks[1], device=dev,
                                    names=GRAPH_KERNELS)
        want.append(out)
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        a = st.create_train_state(cfg, device=dev)
        multi = st.make_multi_train_step(cfg, augment=True,
                                         steps_per_call=GRAPH_K)
        torch.cuda.reset_peak_memory_stats()
        c0 = counters()
        got = [multi(a, cache, blocks[0])]
        out, replayed = kernel_records(multi, a, cache, blocks[1],
                                       device=dev, names=GRAPH_KERNELS)
        got.append(out)
        graph = [x - y for x, y in zip(counters(), c0)]
        graph_peak = torch.cuda.max_memory_allocated()
        state_equal = same_state(a, b)
        terms_equal = all(
            g.keys() == w.keys() and all(torch.equal(v, w[k])
                                         for k, v in g.items())
            for g, w in zip(got, want))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del multi, a, b
    torch.cuda.empty_cache()
    out = {"state_equal": state_equal, "terms_equal": terms_equal,
           "graph_counts": graph, "replayed_kernels": replayed,
           "eager_kernels": eager, "eager_peak_gb": eager_peak / 1e9,
           "graph_peak_gb": graph_peak / 1e9,
           "loss_total": [float(t["loss_total"]) for t in got]}
    log(f"[kstep] {name} K={GRAPH_K} B={GRAPH_B} bf16 from a seeded init: "
        f"two make_multi_train_step calls (1 eager step, a capture, "
        f"{2 * GRAPH_K - 1} replays: counters {graph}) against "
        f"{2 * GRAPH_K} train_step calls, state bitwise {state_equal}, mean "
        f"terms bitwise {terms_equal} (loss_total {out['loss_total']}); in "
        f"profiler traces of the second block, kernels of the replays "
        f"{replayed} against the eager steps' {eager}; peak memory "
        f"{out['graph_peak_gb']:.2f} GB against {out['eager_peak_gb']:.2f} "
        f"GB | {card}")
    if (not state_equal or not terms_equal or replayed != eager
            or graph != [1, 1, 2 * GRAPH_K - 1]
            or eager["ppn_warp_kernel"] != GRAPH_K or eager["ppn_bn_"] == 0):
        raise AssertionError(f"K-step graph at {name}: {out}")
    return out


def sharded_rank(rank: int, world: int, port: int, outdir: str,
                 cases: dict, device: str) -> None:
    """Phase 25's ranks: each joins a gloo world on the loopback address,
    computes on ``device`` (the card's cuda:0) with TF32 off, builds the
    256 cached images sharded over the world and replicated, compares their
    gathered slices, then runs each case's K=2 ``Trainer`` over the sharded
    cache; writes the results to ``<outdir>/rank<r>.pt``."""
    import torch.distributed as dist

    from ppn_tpu_torch.parallel import make_mesh, shard_batch
    from ppn_tpu_torch.parallel.multihost import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(device=device)
        from ppn_tpu_torch.configs import get_config
        from ppn_tpu_torch.data.device_cache import DeviceCache
        from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

        ds = SyntheticPoseDataset(get_config("mpii_r18_384"),
                                  size=TRAIN_IMAGES, seed=0)
        sharded = DeviceCache(ds, device=mesh.device, mesh=mesh)
        replicated = DeviceCache(ds, device=mesh.device)
        rng = np.random.default_rng(25)
        B = cases["bf16"][0].train.batch_size
        equal = []
        for _ in range(SHARDED_BLOCKS):
            idx = rng.choice(TRAIN_IMAGES, B, replace=False)
            got = sharded.batch(idx)
            want = shard_batch(mesh, replicated.batch(idx))
            equal.append(all(torch.equal(v, want[k])
                             for k, v in got.items()))
        out = {"gathers_equal": equal,
               "nbytes": [sharded.nbytes(), replicated.nbytes()]}
        # with cuDNN's default algorithm choice two replays of these f32
        # steps part in the last bits on the H100 (PERF.md §6), so the
        # Trainer runs and the replay they are held to bitwise take its
        # deterministic algorithms; the default's replays are compared for
        # the record
        torch.backends.cudnn.deterministic = True
        out.update(k_step_trainer_runs(cases, sharded, mesh, outdir))
        replay = functools.partial(f32_replay, cases["f32"][0],
                                   out["f32"]["blocks"], replicated, mesh)
        out["f32"]["per_step_equal"] = same_tensors(out["f32"]["state"],
                                                    replay())
        torch.backends.cudnn.deterministic = False
        out["f32"]["default_replays_equal"] = same_tensors(replay(),
                                                           replay())
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def same_tensors(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(v, b[k])
                                        for k, v in a.items())


def f32_replay(cfg, blocks, cache, mesh) -> dict:
    """Phase 25's f32 Trainer run again, one ``train_step`` at a time on
    ``cache``'s slices of its index blocks, from the same start; the model
    state after, on the host."""
    from ppn_tpu_torch.parallel import replicate, shard_batch
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    state = load_npz_into_train_state(
        cfg, SNAPSHOT, st.create_train_state(cfg, device=mesh.device))
    replicate(mesh, state)
    for block in blocks:
        for row in block:
            st.train_step(cfg, state, shard_batch(mesh, cache.batch(row)),
                          augment=True, mesh=mesh)
    return {k: v.cpu() for k, v in state.model.state_dict().items()}


def k_step_trainer_runs(cases: dict, cache, mesh, outdir: str) -> dict:
    """For each case (label → (config, steps)): a ``Trainer`` from the
    snapshot over ``cache`` with augmentation, its K-step loop for the
    steps; the index blocks it drew, the logged (mean) loss terms of each
    block, the state after, the warp launches and the ms per step on the
    host clock."""
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.train.trainer import Trainer

    out = {}
    for label, (cfg, steps) in cases.items():
        d = os.path.join(outdir, f"{label}_{mesh.rank()}")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=d, resume=False, log_every=1,
            checkpoint_every=0, eval_every=0))
        trainer, _ = quiet_call(functools.partial(
            Trainer, cfg, iter([]), logdir=d, augment=True,
            init_npz=SNAPSHOT, device=mesh.device, mesh=mesh,
            device_cache=cache))
        k = cfg.train.steps_per_call
        draw = trainer._index_blocks(cfg.train.batch_size, k, cfg.train.seed)
        blocks = [next(draw).tolist() for _ in range(steps // k)]
        torch.cuda.synchronize()
        cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        quiet_call(trainer.run, steps)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        terms = []
        if mesh.rank() == 0:
            with open(os.path.join(d, "train_metrics.jsonl")) as fh:
                terms = [{k: v for k, v in json.loads(line).items()
                          if k.startswith("loss_")} for line in fh]
        out[label] = {"terms": terms, "launches": cuda_warp.LAUNCHES,
                      "blocks": blocks,
                      "ms_per_step": ms, "state": {
                          k: v.cpu() for k, v in
                          trainer.state.model.state_dict().items()}}
        trainer.close()
    return out


def sharded_phase(cfg, cache, card: str) -> dict:
    """Phase 25: two gloo ranks on the one card with the capacity-sharded
    cache and the K=2 Trainer, against one process on the replicated
    cache."""
    from ppn_tpu_torch.parallel import make_mesh

    cases = {"f32": (constant_lr(cfg, dtype="float32", batch_size=8,
                                 steps_per_call=2), 2),
             "bf16": (constant_lr(cfg, steps_per_call=2), 4)}
    d = tempfile.mkdtemp(prefix="sharded_", dir=os.path.join(ROOT, "build"))
    try:
        torch.backends.cudnn.deterministic = True    # as the ranks run
        one = k_step_trainer_runs(cases, cache, make_mesh(device=cache.device),
                                  os.path.join(d, "one_process"))
        torch.backends.cudnn.deterministic = False
        t0 = time.perf_counter()
        dev = cache.device
        device = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        torch.multiprocessing.spawn(
            sharded_rank, args=(2, free_port(), d, cases, device),
            nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
                 for r in (0, 1)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = {"spawn_s": spawn_s, "one_process_ms_per_step": {
        k: v["ms_per_step"] for k, v in one.items()}}
    got0 = ranks[0]
    f32_rel = max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(got0["f32"]["terms"], one["f32"]["terms"])
                  for k in w)
    bf16_rel = max(abs(g["loss_total"] - w["loss_total"]) / abs(w["loss_total"])
                   for g, w in zip(got0["bf16"]["terms"],
                                   one["bf16"]["terms"]))
    for r, res in enumerate(ranks):
        state_rel, worst = max_rel_state(res["f32"]["state"],
                                         one["f32"]["state"])
        out[f"rank{r}"] = {
            "gathers_equal": res["gathers_equal"],
            "cache_bytes": res["nbytes"][0],
            "replicated_bytes": res["nbytes"][1],
            "f32_state_rel": state_rel, "f32_worst_tensor": worst,
            "launches": [res["f32"]["launches"], res["bf16"]["launches"]],
            "ms_per_step": [res["f32"]["ms_per_step"],
                            res["bf16"]["ms_per_step"]]}
        out[f"rank{r}"].update(
            f32_per_step_equal=res["f32"]["per_step_equal"],
            default_cudnn_replays_equal=res["f32"]["default_replays_equal"])
        log(f"[sharded] rank {r} of 2 (gloo, both on cuda:0): gathered "
            f"slices of {SHARDED_BLOCKS} blocks bitwise the replicated "
            f"cache's {res['gathers_equal']}; cache bytes "
            f"{res['nbytes'][0]} (replicated {res['nbytes'][1]}); K=2 "
            f"Trainer from the snapshot, f32 B=8 one block (cuDNN "
            f"deterministic): state bitwise the same steps one train_step at "
            f"a time on the replicated cache {res['f32']['per_step_equal']} "
            f"(two such replays with cuDNN's default algorithms bitwise "
            f"equal: {res['f32']['default_replays_equal']}), against one "
            f"process "
            f"worst {state_rel:.3g}·max|p| ({worst}; two f32 steps, not "
            f"held: phase 19 holds one at 1e-5); ppn_warp_kernel launches "
            f"{res['f32']['launches']} + {res['bf16']['launches']}; ms per "
            f"step f32 {res['f32']['ms_per_step']:.3f}, bf16 "
            f"{res['bf16']['ms_per_step']:.3f} | {card}")
        if (not all(res["gathers_equal"])
                or not res["f32"]["per_step_equal"]
                or 2 * res["nbytes"][0] != res["nbytes"][1]
                or res["f32"]["launches"] != 2
                or res["bf16"]["launches"] != 4):
            raise AssertionError(f"sharded cache rank {r}: {out}")
    out.update(f32_terms_rel=f32_rel, bf16_loss_rel=bf16_rel)
    log(f"[sharded] rank 0's logged block loss terms against one process: "
        f"f32 worst rel {f32_rel:.3g} (limit 1e-5), bf16 loss_total worst rel "
        f"{bf16_rel:.3g} over {len(one['bf16']['terms'])} blocks (limit "
        f"2e-3); one process ms per step {out['one_process_ms_per_step']}; "
        f"spawn and both ranks {spawn_s:.1f} s | {card}")
    if (f32_rel > 1e-5 or bf16_rel > 2e-3
            or len(got0["bf16"]["terms"]) != 2 or len(got0["f32"]["terms"]) != 1):
        raise AssertionError(f"sharded K=2 Trainer against one process: {out}")
    return out


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


def bench_phase(card: str) -> dict:
    """Phase 26: the port's benchmark suite in this process, one config at
    a time through ``suite.main --configs <c> --out``, the launch counts
    set to 0 before each and read after; each record checked; configs 1
    and 2 again for the spread between runs; the headline
    (``python -m ppn_tpu_torch.bench.headline``) as a subprocess."""
    from ppn_tpu_torch.bench import suite
    from ppn_tpu_torch.ops import cuda_post, cuda_warp

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
    log(f"[bench] headline rc {r.returncode} in {seconds['headline']:.1f} s: "
        f"{r.stdout.strip()}")
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"headline rc {r.returncode}, stdout "
                             f"{r.stdout!r}, stderr {r.stderr[-2000:]!r}")
    head = json.loads(lines[0])
    if (set(head) != HEADLINE_KEYS or not 0 < head["mfu_pct"] <= 100
            or not head["value"] > 0 or head["card"] != card):
        raise AssertionError(f"headline line: {head}")
    log(f"[bench] run to run: config 1 p50 {records['1']['value']} / "
        f"{records['1_again']['value']} ms, config 2 "
        f"{records['2']['value']} / {records['2_again']['value']} img/s | "
        f"{card}")
    return {"records": records, "launches": launches, "seconds": seconds,
            "headline": head}


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


def leftovers_phase(cfg, dev, card: str) -> dict:
    """Phase 27: ``make_grain_loader`` at 4 workers against 0 (batch
    hashes, img/s), 10 ``train_step`` calls on its batches from the
    snapshot with each step's terms through ``MetricLogger(tensorboard=
    True)``, the event file read back by ``read_tfrecords``, and
    ``num_params`` of the model."""
    from ppn_tpu_torch.data.pipeline import make_grain_loader
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.nn import num_params
    from ppn_tpu_torch.ops import cuda_warp
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.utils.logging import MetricLogger
    from ppn_tpu_torch.utils.params_io import load_npz_into_train_state

    tcfg = constant_lr(cfg)
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
        tcfg, SNAPSHOT, st.create_train_state(tcfg, device=dev))
    d = tempfile.mkdtemp(prefix="leftovers_", dir=os.path.join(ROOT, "build"))
    try:
        logger = MetricLogger(d, stdout=False, tensorboard=True)
        logged, ms = [], []
        torch.cuda.synchronize(dev)
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
    finally:
        shutil.rmtree(d, ignore_errors=True)
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
    log(f"[leftovers] make_grain_loader over {PARITY_IMAGES} synthetic "
        f"images, B={B}, {epochs} epochs: {len(batches)} batches, sha256 at "
        f"{PARITY_WORKERS} workers equal to 0 workers {out['hashes_equal']};"
        f" loader img/s (worker start included) {PARITY_WORKERS} workers "
        f"{img_s[PARITY_WORKERS]:.1f}, 0 workers {img_s[0]:.1f} | {card}")
    log(f"[leftovers] {PARITY_STEPS} train_step calls (bf16, augmentation, "
        f"from the snapshot) on those batches: ppn_warp_kernel launches "
        f"{launches}, loss_total {out['loss_total'][0]:.4f} → "
        f"{out['loss_total'][-1]:.4f}, median step {out['step_ms_median']:.3f}"
        f" ms (host clock, terms read back each step) | {card}")
    log(f"[leftovers] {rel}: {out['records']} records (expected "
        f"{out['records_expected']}), every CRC checked, file_version "
        f"{version!r}, every event the logged term as f32 "
        f"{out['events_equal']}; num_params {out['num_params']} (pinned "
        f"{MPII_R18_384_PARAMS})")
    if (not out["hashes_equal"] or len(batches) != PARITY_STEPS
            or launches != PARITY_STEPS or not out["finite"]
            or out["records"] != out["records_expected"]
            or version != "brain.Event:2" or not out["events_equal"]
            or out["num_params"] != MPII_R18_384_PARAMS):
        raise AssertionError(f"parity leftovers: {out}")
    return out


def post_kernel_cases_7x7(dev) -> tuple[int, float]:
    """Phase 28, part 1: ppn_post_kernel against its plain version on
    mpii_r18_224_fast's 7×7 grid (its 9×9 window reaches past the grid from
    every cell) at B=1, 32 and 128 on the seeded kinds, the ``empty`` and
    ``chain`` edge maps and the NaN window case. Returns the worst ulp and
    absolute error."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import KINDS, feature_map_case, nan_window_case

    m = get_config("mpii_r18_224_fast").model
    cases = [(B, kind) for B in (1, 32, 128) for kind in KINDS]
    cases += [(8, "empty"), (8, "chain")]
    worst_ulp, worst_err = 0, 0.0
    for B, kind in cases:
        fm = torch.from_numpy(feature_map_case(m, B, seed=B, kind=kind))
        fm = fm.to(dev)
        got = cuda_post.postprocess_batch_cuda(m, fm)
        want = postprocess_batch_plain(m, fm)
        equal, ulp, err = compare(got, want)
        worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
        log(f"[family] ppn_post_kernel 7x7 B={B} {kind}: decisions_equal="
            f"{equal} max_ulp={ulp} max_abs_err={err:.3g} persons="
            f"{int(want.valid.sum())}")
        if not equal or ulp > ULP_LIMIT:
            raise AssertionError(f"kernel disagrees at 7x7: B={B} {kind}")
    fm = torch.from_numpy(nan_window_case(m)).to(dev)
    got = cuda_post.postprocess_batch_cuda(m, fm)
    equal, ulp, err = compare(got, postprocess_batch_plain(m, fm))
    d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
    cell, score = got.kp_cell[0, 0, d].tolist(), float(got.kp_score[0, 0, d])
    log(f"[family] ppn_post_kernel 7x7 NaN window case: decisions_equal="
        f"{equal} max_ulp={ulp}; slot 0 class {d}: cell {cell} score {score}")
    if not equal or ulp > ULP_LIMIT or cell != [0, 0] or score != 0.0:
        raise AssertionError("kernel disagrees at 7x7: NaN window case")
    return worst_ulp, worst_err


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
            log(f"[family] {label} {dtype} forward, card vs CPU, B=2: max "
                f"|Δ| {rel:.3g} of the largest logit {scale:.4g} (limit "
                f"{tol})")
            if not (math.isfinite(rel) and rel <= tol):
                raise AssertionError(f"{label} {dtype}: card and CPU forwards"
                                     f" differ by {rel} of the largest logit")
            del cpu, card_model
    return out


def family_training_cli(root: str, card: str) -> dict:
    """Phase 28, part 5: ``apps/train.main`` at B=32, bf16, augmentation on,
    FAMILY_STEPS steps from a fresh init on an MPII JPEG tree
    (FAMILY_TRAIN_IMAGES training images, 16 held-out ones to evaluate),
    for ``mpii_r50_384`` and for ``mpii_r18_384 --backbone resnet34``."""
    import re

    from ppn_tpu_torch.apps import train
    from ppn_tpu_torch.ops import cuda_post, cuda_warp

    out = {}
    for label, extra in (("mpii_r50_384", ["--config", "mpii_r50_384"]),
                         ("mpii_r18_384+resnet34", [
                             "--config", "mpii_r18_384", "--backbone",
                             "resnet34"])):
        ck = os.path.join(root, f"ckpt_{label}")
        cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        _, printed = quiet_call(train.main, extra + [
            "--data", "mpii", "--data-root", os.path.join(root, "files"),
            "--batch-size", "32", "--steps", str(FAMILY_STEPS),
            "--no-resume", "--ckpt-dir", ck, "--log-dir", ck,
            "--set", "train.log_every=1"])
        wall = time.perf_counter() - t0
        warp, post = cuda_warp.LAUNCHES, cuda_post.LAUNCHES
        with open(os.path.join(ck, "train_metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        losses = [r["loss_total"] for r in logged if "loss_total" in r]
        step_ms = [1e3 * 32 / r["images_per_sec"] for r in logged
                   if "images_per_sec" in r]
        # the printed dict's values may be numpy scalars: np.float64(0.97)
        evals = [float(m.group(1)) for m in re.finditer(
            r"^eval: .*'pckh/mean': (?:np\.float64\()?([-\d.e]+)", printed,
            re.M)]
        out[label] = {"losses": losses, "warp_launches": warp,
                      "post_launches": post,
                      "step_ms_median": statistics.median(step_ms),
                      "eval_pckh": evals[0] if evals else None,
                      "cli_s": wall}
        log(f"[family] train CLI {label}, B=32 bf16 with augmentation, "
            f"{FAMILY_STEPS} steps from a fresh init on "
            f"{FAMILY_TRAIN_IMAGES} JPEGs: loss_total "
            f"{[round(v, 4) for v in losses]}; ppn_warp_kernel launches "
            f"{warp}; eval: PCKh {out[label]['eval_pckh']} (a fresh init "
            f"after {FAMILY_STEPS} steps) from {post} ppn_post_kernel "
            f"launches; median step {out[label]['step_ms_median']:.3f} ms "
            f"(host clock between the per-step logs; {wall:.1f} s with "
            f"set-up) | {card}")
        if (len(losses) != FAMILY_STEPS or warp != FAMILY_STEPS or post != 2
                or not all(math.isfinite(v) for v in losses)
                or len(evals) != 1 or not math.isfinite(evals[0])):
            raise AssertionError(f"train CLI {label}: {out[label]}")
    return out


def family_phase(images: np.ndarray, fixed: dict, earlier: dict,
                 card: str) -> dict:
    """Phase 28: the rest of the model family on the card at full width —
    the post kernel at 7×7 and the warp kernel at 224² against their plain
    versions and timed; ResNet-34/50 and the 224² forwards against the
    port's CPU path; ``mpii_r50_384`` inference (B=128, ``images``) and
    training (the train CLI, an f32 step against the CPU, an overfit of
    the 8 ``fixed`` images, ``--pretrained``); the ResNet-34 train CLI;
    video at 224². ``earlier`` holds phases 6, 12 and 17's numbers to print
    beside these. Returns the numbers and, under ``overfit_ckpt``, a
    checkpoint directory of the ResNet-50 overfit state (phase 29 exports
    it, then deletes it)."""
    from ppn_tpu_torch.apps import video
    from ppn_tpu_torch.bench.suite import forward_flops, peak_bf16_tflops
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                              heldout_dataset)
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import (affine_warp_separable_plain,
                                         resize_bilinear)
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import feature_map_case, write_mpii_set
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.checkpoint import Checkpointer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}

    # 1. the post kernel at 7×7
    out["post_max_ulp"], out["post_max_abs_err"] = post_kernel_cases_7x7(dev)

    # 2. the warp kernel at 224², bitwise; both kernels timed there
    fast = get_config("mpii_r18_224_fast")
    rng = np.random.default_rng(224)
    x224 = torch.from_numpy(rng.random((32, 224, 224, 3), np.float32)).to(dev)
    mats = warp_matrices(fast, 32, dev, seed=224)
    warp_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        x = x224.to(dt)
        got = cuda_warp.affine_warp_cuda(x, mats)
        want = affine_warp_separable_plain(x, mats)
        d = (got.float() - want.float()).abs()
        warp_err = max(warp_err, float(d.max()))
        log(f"[family] ppn_warp_kernel 224x224x3 B=32 {str(dt)[6:]}: "
            f"differing values {int((d > 0).sum())} of {d.numel()}")
        if not torch.equal(got, want):
            raise AssertionError(f"ppn_warp_kernel differs from its plain "
                                 f"version at 224² {dt}")
    xw = x224.to(torch.bfloat16)
    wcall = functools.partial(cuda_warp.affine_warp_cuda, xw, mats)
    out["warp"] = {"ms": graph_ms(wcall, 50), "bound_ms": warp_bound_ms(xw),
                   "plain_ms": time_ms(
                       lambda: affine_warp_separable_plain(xw, mats), 5),
                   "max_abs_err": warp_err}
    log(f"[family] B=32 224x224x3 bf16: ppn_warp_kernel "
        f"{out['warp']['ms']:.4f} ms (CUDA graph of 50 launches), plain "
        f"{out['warp']['plain_ms']:.3f} ms, bound "
        f"{out['warp']['bound_ms']:.6f} ms (bytes); at 384² (phase 17) "
        f"{earlier['warp_ms']:.4f} ms, bound {earlier['warp_bound_ms']:.6f}"
        f" ms | {card}")
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
            call = functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
            rec = {"ms": graph_ms(call, 50),
                   "plain_ms": time_ms(
                       lambda: postprocess_batch_plain(m, fm), 5),
                   "bound_ms": kernel_bound_ms(m, fm),
                   "bound_ms_whole_map": whole_map_bound_ms(m, b)}
            out["post"][f"{kind}_b{b}"] = rec
            log(f"[family] 7x7 {kind} map B={b}: ppn_post_kernel "
                f"{rec['ms']:.4f} ms (CUDA graph of 50 launches), plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} ms "
                f"(bytes this map needs; whole map "
                f"{rec['bound_ms_whole_map']:.6f} ms); 12x12 main-path map "
                f"(phase 6): {earlier['post_ms'][b]:.4f} ms | {card}")

    # 3. forwards, card against CPU
    out["forwards"] = family_forwards(dev)

    # 4. inference, mpii_r50_384 at B=128
    r50 = get_config("mpii_r50_384")
    pred = Predictor.from_checkpoint(r50, None)
    calls = 0
    cuda_post.LAUNCHES = 0
    for _ in range(3):
        ppl = pred.predict(images)
        calls += 1
    if not all(np.isfinite(getattr(ppl, f)).all() for f in FLOATS):
        raise AssertionError("non-finite ResNet-50 predictions")
    ms = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pred.predict(images)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        calls += 1
    B = images.shape[0]
    med = statistics.median(ms)
    flops = forward_flops(r50, 1)
    ips = 1e3 * B / med
    out["r50_predict"] = {
        "ms_median": med, "img_per_s": ips, "forward_gflop_per_image":
        flops / 1e9, "mfu_pct": flops * ips / (
            peak_bf16_tflops(dev) * 1e12) * 100.0,
        "launches": cuda_post.LAUNCHES, "calls": calls}
    log(f"[family] mpii_r50_384 B={B} predict (seeded init): median "
        f"{med:.3f} ms over 20 calls = {ips:.1f} img/s, "
        f"{flops / 1e9:.3f} GFLOP an image (forward_flops), mfu_pct "
        f"{out['r50_predict']['mfu_pct']:.2f}; ppn_post_kernel launches "
        f"{cuda_post.LAUNCHES} in {calls} calls; mpii_r18_384 (phase 6): "
        f"{1e3 * B / earlier['predict_ms']:.1f} img/s | {card}")
    if cuda_post.LAUNCHES != calls:
        raise AssertionError(f"{cuda_post.LAUNCHES} post launches in {calls}"
                             " ResNet-50 predict calls")
    del pred, ppl

    d = tempfile.mkdtemp(prefix="family_", dir=os.path.join(ROOT, "build"))
    out["overfit_ckpt"] = os.path.join(d, "overfit_r50")
    # 5. the train CLI on files: ResNet-50 and ResNet-34
    mpii = get_config("mpii_r18_384")
    write_mpii_set(mpii, os.path.join(d, "files"), {
        "train": (SyntheticPoseDataset(mpii, size=FAMILY_TRAIN_IMAGES,
                                       seed=0, cache=True, num_persons=2),
                  FAMILY_TRAIN_IMAGES, 0),
        "valid": (heldout_dataset(mpii, num_persons=2), 16, 10_000)}, "jpg")
    out["train_cli"] = family_training_cli(d, card)

    # 6. one f32 ResNet-50 step, card against CPU, from the same state: the
    # loss terms and grad_norm held, the gradients (after a first step from
    # zero momentum each trace is the decayed gradient g + wd·p) and the
    # state after the update printed
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
    log(f"[family] mpii_r50_384 f32 train step, card vs CPU, B=2: loss "
        f"terms worst rel {terms_rel:.3g} (limit {FAMILY_STEP_REL}); "
        f"grad_norm {got['grad_norm']:.6g} vs {want['grad_norm']:.6g}, rel "
        f"{rel['grad_norm']:.3g} (limit {FAMILY_GRAD_NORM_REL}); not held, "
        f"a poorly conditioned gradient: gradients worst {grad_rel:.3g}"
        f"·max|g| ({grad_worst}), state after the step worst "
        f"{state_rel:.3g}·max|p| ({state_worst}); every pixel one ulp up "
        f"moves, against the same side's step, "
        + "; ".join(f"on the {k}: grad_norm rel {v[0]:.3g}, gradients worst "
                    f"{v[1]:.3g}·max|g| ({v[2]})" for k, v in nudge.items()))
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
    log(f"[family] sgd_update from the same state on the same seeded "
        f"gradients, card vs CPU: worst per tensor (·max) "
        + ", ".join(f"{k} {v:.3g} ({n})" for k, (v, n) in update.items())
        + f" (limit {UPDATE_TOL})")
    if max(v for v, _ in update.values()) > UPDATE_TOL:
        raise AssertionError(f"sgd_update, card vs CPU: {update}")
    del cpu_state, gpu_state, cpu_run, gpu_run
    out["blocks"] = {}
    for cin, cout, stride, side in FAMILY_BLOCKS:
        worst = bottleneck_card_vs_cpu(cin, cout, stride, side, dev)
        key = f"{cin}->{cout}x4/s{stride}@{side}"
        out["blocks"][key] = worst
        log(f"[family] Bottleneck {key}, f32 training mode, B=2, card vs "
            f"CPU on seeded inputs and a seeded linear loss, the CPU "
            f"replaying the card's ReLU decisions ({worst['relu_ties']} "
            f"ties it would have decided otherwise): worst per tensor (·max) "
            + ", ".join(f"{k} {worst[k][0]:.3g} ({worst[k][1]})"
                        for k in ("output", "gradients", "statistics"))
            + f" (limits {BLOCK_TOL}, statistics {BLOCK_STATS_TOL}); with "
            f"the CPU's own decisions, gradients "
            f"{worst['own_decisions_gradients'][0]:.3g} "
            f"({worst['own_decisions_gradients'][1]}), not held")
        if (max(worst["output"][0], worst["gradients"][0]) > BLOCK_TOL
                or worst["statistics"][0] > BLOCK_STATS_TOL):
            raise AssertionError(f"Bottleneck {key}: {worst}")

    # 7. overfit the 8 fixed images from a fresh init, kept for phase 29
    ocfg = constant_lr(r50)
    ostate = st.create_train_state(ocfg, device=dev)
    curve = [float(st.train_step(ocfg, ostate, fixed)["loss_total"])
             for _ in range(OVERFIT_STEPS)]
    tail = statistics.fmean(curve[-10:])
    out["overfit"] = {"first": curve[0], "last10_mean": tail}
    log(f"[family] mpii_r50_384 overfit: loss_total first {curve[0]:.4f}, "
        f"mean of the last 10 {tail:.4f} after {OVERFIT_STEPS} steps (every "
        f"10th: {[round(v, 3) for v in curve[::10]]})")
    if not all(math.isfinite(v) for v in curve) or not tail < 0.5 * curve[0]:
        raise AssertionError("the ResNet-50 overfit did not halve the loss")
    Checkpointer(out["overfit_ckpt"]).save(OVERFIT_STEPS, ostate)
    del ostate

    # 8. --pretrained with a torchvision-layout ResNet-50
    pre = pretrained_phase("mpii_r50_384")
    out["pretrained"] = pre
    log(f"[family] apps/train.main --pretrained, ResNet-50: backbone equal "
        f"to the file's {pre['tensors']} tensors before step 1 "
        f"{pre['equal_before_step_1']}; loss_total over 2 steps "
        f"{[round(v, 4) for v in pre['losses']]}")
    if (not pre["equal_before_step_1"] or len(pre["losses"]) != 2
            or not all(math.isfinite(v) for v in pre["losses"])):
        raise AssertionError(f"--pretrained ResNet-50: {pre}")

    # 9. video at 224² (the seeded init: no 224² snapshot exists)
    frame0 = next(video.synthetic_frames(1, fps=0))
    got = video.make_video_pipeline(fast, fpred.model)(frame0)
    with torch.no_grad():
        img = resize_bilinear(torch.from_numpy(frame0).to(dev).float()
                              / 255.0, m.insize)
        want = postprocess_batch_plain(m, fpred.model(img[None]))
    want = type(want)(*(t[0] for t in want))
    equal, ulp, _ = compare(got, want)
    log(f"[family] first 720p frame through the 224² pipeline against the "
        f"plain pipeline: decisions_equal={equal} max_ulp={ulp} persons "
        f"{int(want.valid.sum())}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("224² video pipeline disagrees with the plain "
                             "one")
    cuda_post.LAUNCHES = 0
    summary_v, _ = quiet_call(video.main, [
        "--config", "mpii_r18_224_fast", "--source", "synthetic",
        "--frames", str(VIDEO_FRAMES), "--json"])
    summary_v["launches"] = cuda_post.LAUNCHES
    out["video"] = summary_v
    mpii_v = earlier["video"]
    log(f"[family] video mpii_r18_224_fast (seeded init), {VIDEO_FRAMES} "
        f"720p frames at 30 fps: {json.dumps(summary_v)}; mpii_r18_384 "
        f"(phase 12, the snapshot): p50 {mpii_v['p50_ms']} ms, p90 "
        f"{mpii_v['p90_ms']} ms, fps {mpii_v['fps']} | {card}")
    if summary_v["launches"] != summary_v["frames"] + 1:
        raise AssertionError(f"224² video: {summary_v['launches']} post "
                             f"launches for {summary_v['frames']} frames and "
                             "the warm-up")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[family] phase 28 took {out['seconds']:.1f} s")
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


def tools_phase(overfit_ckpt: str, fixed: dict, card: str) -> dict:
    """Phase 29: the four accuracy tools through their ``main`` on the card
    against the JAX package's values on its CPU (``TOOL_PINS``), and the
    export of phase 28's ResNet-50 overfit checkpoint reloaded by
    ``Predictor.from_npz``; deletes the checkpoint's directory."""
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops import cuda_post
    from ppn_tpu_torch.train.checkpoint import load_state
    from ppn_tpu_torch.train.steps import eval_model
    from tools import (torch_crowding_study, torch_export_snapshot,
                       torch_oracle_ceiling, torch_threshold_sweep)

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
    log(f"[tools] torch_oracle_ceiling {name}, {size} images, {persons} "
        f"persons: {printed.strip()} (pin {pin}); ppn_post_kernel launches "
        f"{cuda_post.LAUNCHES}")
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
            cmd = " ".join(["torch_threshold_sweep", *extra])
            log(f"[tools] {cmd} ({dtype}): {points}; ppn_post_kernel "
                f"launches {cuda_post.LAUNCHES}")
            launches.setdefault(label, []).append(cuda_post.LAUNCHES)
            if cuda_post.LAUNCHES != len(points) or len(points) != 6:
                raise AssertionError(f"{label}: {cuda_post.LAUNCHES} post "
                                     f"launches for {len(points)} points")
            return points

        out[label] = model_points(label, sweep, TOOL_PINS[label], card)

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
        log(f"[tools] torch_crowding_study ({dtype}) on the crowd "
            f"snapshot, {TOOL_CROWD_IMAGES} "
            f"images a protocol: (collision bound, lost-person fraction, "
            f"oracle ceilings) {exact}; ppn_post_kernel launches "
            f"{cuda_post.LAUNCHES}")
        launches.setdefault("crowd", []).append(cuda_post.LAUNCHES)
        if exact != TOOL_PINS["crowd"]["exact"] or cuda_post.LAUNCHES != 24:
            raise AssertionError(f"crowding study: {exact} (pinned "
                                 f"{TOOL_PINS['crowd']['exact']}), "
                                 f"{cuda_post.LAUNCHES} launches")
        return {f"{r['protocol']}@{p['nms']}": p["model_pckh"]
                for r in study["results"] for p in r["points"]}

    out["crowd"] = model_points("crowd", crowd, TOOL_PINS["crowd"], card)

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
            x = fixed["image"]
            a, b = reloaded(x), mem(x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(os.path.dirname(overfit_ckpt), ignore_errors=True)
    out["export"] = {
        "printed": printed.strip(),
        "logits_equal": bool(((a == b) | (a.isnan() & b.isnan())).all()),
        "values_beyond_f16": beyond_f16,
        "nonfinite_logits": int((~torch.isfinite(a)).sum())}
    log(f"[tools] torch_export_snapshot: {printed.strip()}; values beyond "
        f"f16's range (written as ±inf, as the JAX exporter writes them) "
        f"{beyond_f16}; Predictor.from_npz logits on the 8 overfit images "
        f"equal to the in-memory eval model's with f16-rounded parameters "
        f"and statistics (cudnn.deterministic): "
        f"{out['export']['logits_equal']} ({out['export']['nonfinite_logits']}"
        f" non-finite)")
    if (not out["export"]["logits_equal"]
            or out["export"]["nonfinite_logits"]):
        raise AssertionError(f"exported snapshot: {out['export']}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tools] phase 29 took {out['seconds']:.1f} s")
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


def split_tools_phase(dev, card: str) -> dict:
    """Phase 30: the stage profilers (``tools/torch_{train,bwd,fwd}_split.py``)
    through their ``main`` on the card, after ``split_checks``; the warp
    launches of the train split against ``split_warp_launches``, and no
    post launch anywhere."""
    from ppn_tpu_torch.ops import cuda_post, cuda_warp
    from tools import torch_bwd_split, torch_fwd_split, torch_train_split

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        checks = split_checks(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[split] stages composed bitwise backbone(x), B={SPLIT_CHECK_BATCH}"
        f": {checks['stages_compose']}; fwd_split ingest∘blocks∘head "
        f"bitwise model(img) at B={SPLIT_FWD_BATCH}: "
        f"{checks['fwd_split_is_model']}; s2d stem against the 7×7 stem: "
        f"max|Δ| {checks['s2d_max_abs_diff']:.4g} of max|y| "
        f"{checks['stem7_max_abs']:.4g} (limit {BF16_TOL} of it) | {card}")
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

    rec = run("train_split", torch_train_split,
              ["--batch", str(SPLIT_TRAIN_BATCH)])
    busy = {k: round(v["total"], 3) for k, v in rec["device_busy_ms"].items()}
    log(f"[split] torch_train_split mpii_r18_384 B={SPLIT_TRAIN_BATCH}: "
        f"full step {rec['full_step_ms']} ms, no_augment "
        f"{rec['no_augment_step_ms']} ms, device_ms {rec['device_ms']}, "
        f"busy ms {busy}, host_bound {rec['host_bound']} | {card}")
    for label, name, fields, batches in SPLIT_BWD_RUNS:
        bn = ["--batch-norm"] if label == "resnet18" else []
        rec = run(f"bwd_split_{label}", torch_bwd_split,
                  ["--config", name, "--batches", batches] + bn, fields)
        for row in rec["batches"]:
            log(f"[split] torch_bwd_split {label} B={row['batch']}: "
                f"fwd {row['sum_fwd_ms']} ms, fwd+bwd {row['sum_fwdbwd_ms']}"
                f" ms; by stage fwd+bwd (busy, host-bound) " + ", ".join(
                    f"{n} {st['fwdbwd_ms']} "
                    f"({st['device_busy_ms']['fwdbwd']['total']:.3f}, "
                    f"{st['host_bound']['fwdbwd']})"
                    for n, st in row["stages"].items()) + f" | {card}")
            if "batch_norm" in row:
                norm = row["batch_norm"]
                kinds = {k: {c: round(v, 3) for c, v in b.items()
                             if c not in ("recorded", "windows")}
                         for k, b in norm["device_busy_ms"].items()}
                log(f"[split] {label} B={row['batch']}: its "
                    f"{norm['layers']} BatchNorm layers alone: fwd "
                    f"{norm['fwd_ms']} ms, fwd+bwd {norm['fwdbwd_ms']} ms, "
                    f"busy by category {kinds}, host-bound "
                    f"{norm['host_bound']} | {card}")
        bn_layers = [row["batch_norm"]["layers"] for row in rec["batches"]
                     if "batch_norm" in row]
        if bn and bn_layers != [SPLIT_BN_LAYERS] * len(rec["batches"]):
            raise AssertionError(f"{label}: BatchNorm layers timed "
                                 f"{bn_layers}, expected {SPLIT_BN_LAYERS}")
    rec = run("fwd_split", torch_fwd_split,
              ["--batch", str(SPLIT_FWD_BATCH)])
    log(f"[split] torch_fwd_split mpii_r18_384 B={SPLIT_FWD_BATCH}: " +
        ", ".join(f"{k} {v}" for k, v in rec.items() if k != "device_busy_ms"
                  and (k.endswith("_ms") or k == "s2d_max_abs_diff"))
        + f"; host_bound {rec['host_bound']} | {card}")

    want_warp = split_warp_launches(SPLIT_ITERS, out["train_split"])
    out["launches"] = launches
    out["warp_launches_expected"] = want_warp
    log(f"[split] launches (post, warp) per tool run: {launches}; "
        f"ppn_warp_kernel expected in the train split {want_warp}")
    out["rows_missing_kernels"] = missing = [
        (label, row) for label, row, busy in split_busy_rows(out)
        if busy["recorded"] < 1.0]
    log(f"[split] rows whose profiler windows left kernels unrecorded "
        f"(busy a lower bound there, host_bound None): {missing} | {card}")
    if (launches["train_split"] != [0, want_warp]
            or any(v != [0, 0] for k, v in launches.items()
                   if k != "train_split")):
        raise AssertionError(f"stage profiler launches: {launches}, "
                             f"expected warp {want_warp}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[split] phase 30 took {out['seconds']:.1f} s | {card}")
    return out


def model_points(label: str, run, pins: dict, card: str) -> dict:
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
        log(f"[tools] {label} ({dtype}): points off the JAX package's "
            f"{dtype} values by more than {TOOL_TOLERANCE}: {misses}"
            + (f" (allowed: {list(known)} within {gap:.4g}, the JAX "
               f"package's own bf16-to-f32 gap)" if dtype == "bf16" and known
               else "") + f" | {card}")
        if bad:
            raise AssertionError(f"{label} ({dtype}): points {got}, pinned "
                                 f"{want}, failing {bad}")
    return out


# phase 29: the train fields that make a tool's forward compute in a dtype
COMPUTE_FIELDS = {"bf16": {}, "f32": {"dtype": "float32"}}


@contextlib.contextmanager
def replacing_config(**sections):
    """While open, ``ppn_tpu_torch.configs.get_config`` gives each config
    with the fields of each named section replaced, as in
    ``replacing_config(model={"backbone": "resnet34"})`` or
    ``replacing_config(train={"dtype": "float32"})``. The tools read their
    config through it at call time, so this sets what they take no flag
    for."""
    from ppn_tpu_torch import configs

    get = configs.get_config

    def patched(name, **overrides):
        cfg = get(name, **overrides)
        return dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), **v)
            for k, v in sections.items()})

    configs.get_config = patched
    try:
        yield
    finally:
        configs.get_config = get


def main() -> int:
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                              heldout_dataset)
    from ppn_tpu_torch.eval.runner import evaluate_oks, evaluate_pckh
    from ppn_tpu_torch.inference import Predictor, fetch_async, wait_host
    from ppn_tpu_torch.ops import cuda_bn, cuda_build, cuda_post, cuda_warp
    from ppn_tpu_torch.ops.image import (affine_warp_separable_plain,
                                         resize_bilinear)
    from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
    from ppn_tpu_torch.testing import (KINDS, feature_map_case,
                                       nan_window_case)
    from ppn_tpu_torch.train import steps as st
    from ppn_tpu_torch.train.trainer import Trainer

    card = smi_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build -----------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from ppn_tpu_torch.native import loader as native_loader

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

    # ---- 3. post kernel against plain on the card ---------------------------
    # every batch and threshold set the main paths give the kernel: the
    # server's power-of-two buckets up to 32, the suite's B=32 inference on
    # mpii_r18_384 and on coco_r18_384 (det 0.15 / nms 0.3), B=128
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
        m = get_config(name).model
        fm = torch.from_numpy(feature_map_case(m, B, seed=B, kind=kind))
        fm = fm.to(dev)
        got = cuda_post.postprocess_batch_cuda(m, fm)
        want = postprocess_batch_plain(m, fm)
        torch.cuda.synchronize()
        equal, ulp, err = compare(got, want)
        worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
        log(f"[kernel] {name} B={B} {kind}: decisions_equal={equal} "
            f"max_ulp={ulp} max_abs_err={err:.3g} "
            f"persons={int(want.valid.sum())}")
        if not equal or ulp > ULP_LIMIT:
            raise AssertionError(f"kernel disagrees: {name} B={B} {kind}")
    for name in ("tiny_test", "mpii_r18_384", "coco_r18_384_crowded"):
        m = get_config(name).model
        fm = torch.from_numpy(nan_window_case(m)).to(dev)
        got = cuda_post.postprocess_batch_cuda(m, fm)
        want = postprocess_batch_plain(m, fm)
        torch.cuda.synchronize()
        equal, ulp, err = compare(got, want)
        d = m.edges[next(i for i, (s, _) in enumerate(m.edges) if s == 0)][1]
        cell, score = got.kp_cell[0, 0, d].tolist(), float(got.kp_score[0, 0, d])
        log(f"[kernel] {name} NaN window case: decisions_equal={equal} "
            f"max_ulp={ulp}; slot 0 class {d}: cell {cell} score {score}")
        if not equal or ulp > ULP_LIMIT or cell != [0, 0] or score != 0.0:
            raise AssertionError(f"kernel disagrees: {name} NaN window case")

    # ---- 4. warp kernel against plain on the card ---------------------------
    mpii = get_config("mpii_r18_384")
    t0 = time.perf_counter()
    train_ds = SyntheticPoseDataset(mpii, size=TRAIN_IMAGES, seed=0,
                                    cache=True)
    cache = DeviceCache(train_ds, device=dev)
    log(f"[data] {TRAIN_IMAGES} synthetic images rendered and cached on the "
        f"card ({cache.nbytes() / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    tiny = get_config("tiny_test")
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
        for dt in (torch.bfloat16, torch.float32):
            x = images.to(dt)
            got = cuda_warp.affine_warp_cuda(x, mats)
            want = affine_warp_separable_plain(x, mats)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            n_diff = int((d > 0).sum())
            warp_err = max(warp_err, float(d.max()))
            warp_pixels += d.numel()
            log(f"[warp] {label} {str(dt)[6:]}: differing values {n_diff} "
                f"of {d.numel()}, max_abs_err {float(d.max()):.3g}")
            if n_diff:
                raise AssertionError(f"ppn_warp_kernel differs from its "
                                     f"plain version: {label} {dt}")
    bn = bn_phase(dev, card)

    # ---- 5. inference path: snapshot PCKh through the kernel ----------------
    cfg = get_config("mpii_r18_384")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=0.02, nms_thresh=0.45))
    pred = Predictor.from_npz(cfg, SNAPSHOT)
    val = heldout_dataset(cfg, num_persons=2)
    calls = 0

    def predict(images):
        nonlocal calls
        calls += 1
        return pred.predict(images)

    cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
    t0 = time.perf_counter()
    summary = evaluate_pckh(cfg, predict, val, max_images=16, batch_size=8)
    pckh, joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[main] PCKh {pckh:.4f} over {joints:.0f} joints "
        f"({time.perf_counter() - t0:.1f} s, {calls} predict calls)")
    if abs(pckh - PINNED_PCKH) >= 3e-3 or joints != PINNED_JOINTS:
        raise AssertionError(f"PCKh {pckh} / {joints} joints, pinned "
                             f"{PINNED_PCKH} / {PINNED_JOINTS}")

    # ---- 6. inference path at full width: B=128 uint8 through predict ------
    B = 128
    images = np.random.default_rng(0).integers(
        0, 256, (B, *cfg.model.insize, 3), dtype=np.uint8)
    for _ in range(3):
        ppl = predict(images)
    for f in FLOATS:
        if not np.isfinite(getattr(ppl, f)).all():
            raise AssertionError(f"non-finite {f} at B={B}")
    ms = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        predict(images)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    launches = cuda_post.LAUNCHES
    med = statistics.median(ms)
    log(f"[main] B={B} predict: median {med:.3f} ms over {len(ms)} calls "
        f"(min {min(ms):.3f}, max {max(ms):.3f}) = {1e3 * B / med:.1f} img/s")
    log(f"[main] ppn_post_kernel launches {launches} over {calls} predict "
        f"calls; ppn_warp_kernel launches {cuda_warp.LAUNCHES}")
    if launches == 0 or launches != calls:
        raise AssertionError(f"{launches} kernel launches for {calls} calls")

    # ---- post kernel times at the inference path's shapes -------------------
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        fm128 = pred.model(x)
        fm1 = pred.model(x[:1])
    m = cfg.model
    got = cuda_post.postprocess_batch_cuda(m, fm128)
    want = postprocess_batch_plain(m, fm128)
    equal, ulp, err = compare(got, want)
    log(f"[kernel] main-path map B={B}: decisions_equal={equal} "
        f"max_ulp={ulp} max_abs_err={err:.3g}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("kernel disagrees on the main-path map")
    worst_ulp, worst_err = max(worst_ulp, ulp), max(worst_err, err)
    times, post_stages = {}, {}
    for b, fm in ((1, fm1), (B, fm128)):
        call = functools.partial(cuda_post.postprocess_batch_cuda, m, fm)
        k_ms, eager_ms = graph_ms(call, 50), time_ms(call, 50)
        call_us = host_us(call, 200)
        p_ms = time_ms(lambda: postprocess_batch_plain(m, fm), 5)
        bound, whole = kernel_bound_ms(m, fm), whole_map_bound_ms(m, b)
        times[b] = (k_ms, p_ms, bound, whole, eager_ms, call_us)
        log(f"[time] B={b}: ppn_post_kernel {k_ms:.4f} ms (CUDA graph of 50 "
            f"launches; back to back through the wrapper {eager_ms:.4f} ms, "
            f"the wrapper's host time {call_us:.1f} µs a call), plain "
            f"{p_ms:.3f} ms, bound {bound:.6f} ms (bytes this map needs; "
            f"whole map {whole:.6f} ms) | {card}")
    for kind, maps in (("main", {1: fm1, B: fm128}), ("normal", {
            b: torch.from_numpy(feature_map_case(m, b, seed=b)).to(dev)
            for b in (1, B)})):
        for b, fm in maps.items():
            us, span = post_stage_us(m, fm, 20)
            post_stages[kind, b] = dict(us, span=span)
            log(f"[stages] {kind} map B={b}: "
                + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
                + f" µs (sum {sum(us.values()):.3f}; mean over CTAs and "
                f"20 launches); launch span {span:.3f} µs | {card}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: pred.model(x), 10)
    log(f"[time] B={B}: model forward {fwd_ms:.3f} ms | {card}")
    del fm128, x

    # ---- 7. flip-TTA: PCKh through the kernel, B=128 throughput -------------
    tpred = Predictor.from_npz(cfg, SNAPSHOT, flip_tta=True)
    tcalls = 0

    def tpredict(images):
        nonlocal tcalls
        tcalls += 1
        return tpred.predict(images)

    cuda_post.LAUNCHES = 0
    summary = evaluate_pckh(cfg, tpredict, val, max_images=16, batch_size=8)
    tta_launches = cuda_post.LAUNCHES
    tta_pckh, tta_joints = summary["pckh/mean"], summary["pckh/num_joints"]
    log(f"[tta] flip-TTA PCKh {tta_pckh:.5f} over {tta_joints:.0f} joints "
        f"(pinned {PINNED_TTA_PCKH} over {PINNED_JOINTS}); ppn_post_kernel "
        f"launches {tta_launches} over {tcalls} predict calls")
    if (abs(tta_pckh - PINNED_TTA_PCKH) >= 3e-3
            or tta_joints != PINNED_JOINTS or tta_launches != tcalls):
        raise AssertionError(f"flip-TTA PCKh {tta_pckh} / {tta_joints} "
                             f"joints, {tta_launches} launches in {tcalls} "
                             "calls")
    for _ in range(3):
        tpred.predict(images)
    tta_ms = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tpred.predict(images)
        end.record()
        torch.cuda.synchronize()
        tta_ms.append(start.elapsed_time(end))
    tta_med = statistics.median(tta_ms)
    log(f"[tta] B={B} TTA predict: median {tta_med:.3f} ms over "
        f"{len(tta_ms)} calls (min {min(tta_ms):.3f}, max {max(tta_ms):.3f})"
        f" = {1e3 * B / tta_med:.1f} img/s (without TTA {1e3 * B / med:.1f}"
        f") | {card}")

    # ---- 8. evaluation: COCO OKS AP through the kernel, the evaluate CLI ----
    from ppn_tpu_torch.apps import evaluate

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
        in_predict = []

        def timed_predict(images):
            t0 = time.perf_counter()
            out = epred.predict(images)
            in_predict.append(time.perf_counter() - t0)
            return out

        cuda_post.LAUNCHES = 0
        t0 = time.perf_counter()
        summary = evaluate_oks(ecfg, timed_predict, eval_set, max_images=16,
                               batch_size=8)
        first_s, e_launches = time.perf_counter() - t0, cuda_post.LAUNCHES
        in_predict.clear()          # again, warm: cuDNN set up, images cached
        t0 = time.perf_counter()
        again = evaluate_oks(ecfg, timed_predict, eval_set, max_images=16,
                             batch_size=8)
        warm_s = time.perf_counter() - t0
        evaluation[label] = dict(
            summary, launches=e_launches, pinned_ap=pin,
            repeat_equal=again == summary,
            first_ms_per_image=1e3 * first_s / 16,
            ms_per_image=1e3 * warm_s / 16,
            predict_ms_per_image=1e3 * sum(in_predict) / 16)
        log(f"[eval] {label}: OKS AP {summary['oks/AP']:.6f} (pinned {pin} "
            f"± {OKS_TOLERANCE}), AP50 {summary['oks/AP50']:.6f}, AP75 "
            f"{summary['oks/AP75']:.6f}, {summary['oks/num_gt']:.0f} GT; "
            f"ppn_post_kernel launches {e_launches} for 2 batches of 8; wall "
            f"{1e3 * warm_s / 16:.3f} ms per image warm ("
            f"{1e3 * sum(in_predict) / 16:.3f} in predict, the rest "
            f"batching and OKS matching on the host), {1e3 * first_s / 16:.3f}"
            f" ms cold | {card}")
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
            log(f"[eval] evaluate CLI, thresholds from {label}: {got}; "
                f"ppn_post_kernel launches {cuda_post.LAUNCHES}")
            if got != want or returned != want or cuda_post.LAUNCHES != 2:
                raise AssertionError(f"evaluate CLI ({label}) printed {got},"
                                     f" the library {want}")

    # ---- 9. real-data input: the CLIs on MPII and COCO files --------------
    files = file_input_phase(pred.model, card)
    log(f"[files] phase 8 on the synthetic images in memory, for "
        f"comparison: coco {evaluation['coco']['ms_per_image']:.3f} ms per "
        f"image warm, {evaluation['coco']['first_ms_per_image']:.3f} ms cold "
        f"| {card}")

    # ---- 10. B=1 latency ----------------------------------------------------
    one = images[0]
    latency = {}
    for label, p_ in (("plain", pred), ("tta", tpred)):
        for _ in range(10):
            p_.predict_single(one)
        cuda_post.LAUNCHES = 0
        p50, p90 = percentiles_ms(lambda: p_.predict_single(one),
                                  LATENCY_CALLS)
        latency[label] = {"p50_ms": p50, "p90_ms": p90,
                          "launches": cuda_post.LAUNCHES}
        log(f"[b1] predict_single, {label}: p50 {p50:.3f} ms, p90 "
            f"{p90:.3f} ms over {LATENCY_CALLS} calls; ppn_post_kernel "
            f"launches {cuda_post.LAUNCHES} | {card}")
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
    log("[b1] split of one B=1 call (median CUDA-event ms of 50; the "
        "kernel's as a CUDA-graph replay; the wrapper's host µs): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" | {card}")

    # ---- 11. server: micro-batched requests, verified bitwise ---------------
    from ppn_tpu_torch.apps import serve, video

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
    log(f"[serve] {json.dumps(server)} | {card}")
    log(f"[serve] ppn_post_kernel launches {serve_launches} = {warm} "
        f"warm-up + {served} batches served + {direct} direct predicts of "
        "the check")
    if (rc != 0 or server["mismatches"] != 0
            or serve_launches != warm + served + direct):
        raise AssertionError(f"server self-test failed: rc {rc}, "
                             f"{serve_launches} launches, {server}")

    # ---- 12. video: 720p frames, on-device resize ---------------------------
    vcfg = get_config("mpii_r18_384")    # the video app's thresholds
    frame0 = next(video.synthetic_frames(1, fps=0))
    got = video.make_video_pipeline(vcfg, pred.model)(frame0)
    with torch.no_grad():
        img = resize_bilinear(torch.from_numpy(frame0).to(dev).float() / 255.0,
                              vcfg.model.insize)
        want = postprocess_batch_plain(vcfg.model, pred.model(img[None]))
    want = type(want)(*(t[0] for t in want))
    equal, ulp, err = compare(got, want)
    log(f"[video] first 720p frame through the pipeline against the plain "
        f"pipeline: decisions_equal={equal} max_ulp={ulp} persons "
        f"{int(want.valid.sum())}")
    if not equal or ulp > ULP_LIMIT:
        raise AssertionError("video pipeline disagrees with the plain one")
    videos = {}
    for label, extra in (("overlap", []), ("no_overlap", ["--no-overlap"])):
        cuda_post.LAUNCHES = 0
        summary_v, _ = quiet_call(video.main, [
            "--config", "mpii_r18_384", "--ckpt-dir", SNAPSHOT, "--source",
            "synthetic", "--frames", str(VIDEO_FRAMES), "--json", *extra])
        summary_v["launches"] = cuda_post.LAUNCHES
        videos[label] = summary_v
        log(f"[video] {label}: {json.dumps(summary_v)} (launches include "
            f"the warm-up frame) | {card}")
        if summary_v["launches"] != summary_v["frames"] + 1:
            raise AssertionError(f"video: {summary_v['launches']} post "
                                 f"launches for {summary_v['frames']} frames"
                                 " and the warm-up")
    del pred, tpred, fm1

    # ---- 13. one train step on the card against the CPU ---------------------
    tcfg = dataclasses.replace(tiny, train=dataclasses.replace(
        tiny.train, dtype="float32", lr_schedule="constant",
        warmup_steps=0, learning_rate=0.05, ema_decay=0.9))
    cpu_state = st.create_train_state(tcfg, device="cpu")
    gpu_state = st.create_train_state(tcfg, device=dev)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    tiny_batch = DeviceCache(SyntheticPoseDataset(tiny, size=2, seed=1),
                             device="cpu").batch([0, 1])
    want = st.train_step(tcfg, cpu_state, tiny_batch)
    got = st.train_step(tcfg, gpu_state, tiny_batch)
    rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in want if k.startswith("loss_")}
    log(f"[step] tiny_test f32 train step, card vs CPU, worst rel "
        f"{max(rel.values()):.3g} ({max(rel, key=rel.get)}); grad_norm "
        f"{float(got['grad_norm']):.6g} vs {float(want['grad_norm']):.6g}")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card and CPU train steps disagree: {rel}")

    # ---- 14. training path: fine-tune at full width, resume, evaluate -------
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(
        ROOT, "build"))
    try:
        train_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt_dir, log_every=10,
            checkpoint_every=0, eval_every=0))
        batches = cache.infinite_batches(train_cfg.train.batch_size, seed=0)
        cuda_post.LAUNCHES = cuda_warp.LAUNCHES = 0
        t0 = time.perf_counter()
        trainer = Trainer(train_cfg, batches, val_dataset=val,
                          logdir=ckpt_dir, device_cache=cache,
                          init_npz=SNAPSHOT, device=dev)
        final = trainer.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        with open(os.path.join(ckpt_dir, "train_metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        losses = [r["loss_total"] for r in logged] + [final["loss_total"]]
        log(f"[train] {TRAIN_STEPS} steps at B={train_cfg.train.batch_size} "
            f"in {run_s:.1f} s (Trainer set-up included); loss_total at "
            f"steps {[r['step'] for r in logged]}: "
            f"{[round(v, 4) for v in losses[:-1]]}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        resumed = Trainer(train_cfg, batches, val_dataset=val, device=dev)
        a = trainer.state.model.state_dict()
        b = resumed.state.model.state_dict()
        same = all(torch.equal(a[k], b[k]) for k in a)
        log(f"[train] resumed at step {resumed.step}, parameters and "
            f"BatchNorm statistics bitwise equal: {same}")
        if resumed.step != TRAIN_STEPS or not same:
            raise AssertionError("resume did not restore the step and params")
        t0 = time.perf_counter()
        summary = resumed.evaluate(max_images=16, batch_size=8)
        warp_launches, post_train_launches = (cuda_warp.LAUNCHES,
                                              cuda_post.LAUNCHES)
        log(f"[train] PCKh after {TRAIN_STEPS} fine-tune steps "
            f"{summary['pckh/mean']:.4f} over "
            f"{summary['pckh/num_joints']:.0f} joints "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"[train] ppn_warp_kernel launches {warp_launches} over "
            f"{TRAIN_STEPS} steps; ppn_post_kernel launches "
            f"{post_train_launches} in the evaluation")
        if warp_launches != TRAIN_STEPS or post_train_launches == 0:
            raise AssertionError("the training path missed a kernel")
        if not math.isfinite(summary["pckh/mean"]):
            raise AssertionError("non-finite PCKh")

        # ---- 15. training times ---------------------------------------------
        state = trainer.state
        step_ms = []
        for _ in range(20):
            batch = next(batches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            st.train_step(train_cfg, state, batch, augment=True)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        step_med = statistics.median(step_ms)
        bs = train_cfg.train.batch_size
        log(f"[time] train step B={bs} bf16 with augmentation: median "
            f"{step_med:.3f} ms over {len(step_ms)} steps (min "
            f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
            f"{1e3 * bs / step_med:.1f} img/s | {card}")
        stages = train_stage_ms(train_cfg, state, next(batches), 10)
        log("[time] train step stages (CUDA events, mean of 10): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
            + f" | {card}")
        trainer.close()
        resumed.close()
        del trainer, resumed, state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- 16. overfit 8 fixed images from a fresh init -----------------------
    ocfg = dataclasses.replace(mpii, train=dataclasses.replace(
        mpii.train, lr_schedule="constant", warmup_steps=0,
        learning_rate=mpii.train.learning_rate))
    ostate = st.create_train_state(ocfg, device=dev)
    fixed = cache.batch(np.arange(8))
    curve = [float(st.train_step(ocfg, ostate, fixed)["loss_total"])
             for _ in range(OVERFIT_STEPS)]
    tail = statistics.fmean(curve[-10:])
    log(f"[overfit] loss_total first {curve[0]:.4f}, mean of the last 10 "
        f"{tail:.4f} after {OVERFIT_STEPS} steps (every 10th: "
        f"{[round(v, 3) for v in curve[::10]]})")
    if not all(math.isfinite(v) for v in curve) or not tail < 0.5 * curve[0]:
        raise AssertionError("the overfit check did not halve the loss")
    del ostate

    # ---- 17. warp kernel times at the training path's shape -----------------
    xw = cache.data["image"][:32].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    mw = warp_matrices(mpii, 32, dev, seed=32)
    wcall = functools.partial(cuda_warp.affine_warp_cuda, xw, mw)
    w_ms, w_eager_ms = graph_ms(wcall, 50), time_ms(wcall, 50)
    wp_ms = time_ms(lambda: affine_warp_separable_plain(xw, mw), 5)
    w_bound = warp_bound_ms(xw)
    log(f"[time] B=32 384x384x3 bf16: ppn_warp_kernel {w_ms:.4f} ms (CUDA "
        f"graph of 50 launches; back to back {w_eager_ms:.4f} ms), plain "
        f"{wp_ms:.3f} ms, bound {w_bound:.6f} ms (bytes) | {card}")
    # B=128, the batch of the suite's configs 3b and 3c: held bitwise, timed
    x128 = cache.data["image"][:128].to(torch.float32).div(255.0).to(
        torch.bfloat16)
    m128 = warp_matrices(mpii, 128, dev, seed=128)
    got = cuda_warp.affine_warp_cuda(x128, m128)
    if not torch.equal(got, affine_warp_separable_plain(x128, m128)):
        raise AssertionError("ppn_warp_kernel differs from its plain version "
                             "at B=128")
    w128_ms = graph_ms(functools.partial(cuda_warp.affine_warp_cuda, x128,
                                         m128), 50)
    wp128_ms = time_ms(lambda: affine_warp_separable_plain(x128, m128), 5)
    w128_bound = warp_bound_ms(x128)
    log(f"[time] B=128 384x384x3 bf16: ppn_warp_kernel {w128_ms:.4f} ms "
        f"(CUDA graph of 50 launches; bitwise its plain version), plain "
        f"{wp128_ms:.3f} ms, bound {w128_bound:.6f} ms (bytes) | {card}")

    # ---- 18. data-parallel training, one rank over NCCL ---------------------
    dp1 = dp_one_rank(cfg, train_ds, val, dev)
    ref, nccl = dp1["no_group"], dp1["nccl"]
    dp1_equal = {
        "state": all(torch.equal(v, nccl["state"][k])
                     for k, v in ref["state"].items()),
        "ema": (ref["ema"] is None) == (nccl["ema"] is None) and all(
            torch.equal(v, nccl["ema"][k])
            for k, v in (ref["ema"] or {}).items()),
        "terms": ref["terms"] == nccl["terms"]}
    differing = [(i, k) for i, (a, b) in enumerate(zip(ref["terms"],
                                                        nccl["terms"]))
                 for k in a if a[k] != b.get(k)]
    log(f"[dp1] {DP_STEPS} Trainer steps at B={cfg.train.batch_size} bf16 "
        f"with augmentation from the snapshot: rank 0 of an NCCL world of one "
        f"against no process group, bitwise equal {dp1_equal}; loss_total "
        f"{[round(t['loss_total'], 4) for t in nccl['terms']]}; "
        f"ppn_warp_kernel launches {nccl['warp']} (no group: {ref['warp']}); "
        f"Trainer.evaluate under the mesh: PCKh "
        f"{nccl['pckh']['pckh/mean']:.4f}, ppn_post_kernel launches "
        f"{nccl['post']}; (step, term) differing: {differing}")
    if (not all(dp1_equal.values()) or nccl["warp"] != DP_STEPS
            or ref["warp"] != DP_STEPS or nccl["post"] != 2):
        raise AssertionError(f"one-rank data parallel: {dp1_equal}, "
                             f"{nccl['warp']} warp and {nccl['post']} post "
                             "launches")
    dp1_report = {"bitwise_equal": dp1_equal, "warp_launches": nccl["warp"],
                  "post_launches_evaluate": nccl["post"],
                  "pckh": nccl["pckh"]["pckh/mean"]}
    del dp1, ref, nccl

    # ---- 19. data-parallel training, two ranks on the card over gloo -------
    f32 = constant_lr(cfg, dtype="float32", batch_size=8)
    bf16 = constant_lr(cfg)
    rng = np.random.default_rng(18)
    cases = {"f32": (f32, [{k: v.cpu() for k, v in cache.batch(
                 rng.choice(TRAIN_IMAGES, 8, replace=False)).items()}]),
             "bf16": (bf16, [{k: v.cpu() for k, v in cache.batch(
                 rng.choice(TRAIN_IMAGES, bf16.train.batch_size,
                            replace=False)).items()}
                 for _ in range(DP_BF16_STEPS)])}
    from ppn_tpu_torch.parallel import make_mesh

    one = dp_steps(cases, make_mesh(device=dev))
    d = tempfile.mkdtemp(prefix="dp2_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(dp_rank, args=(2, free_port(), d, cases),
                                    nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
                 for r in (0, 1)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    dp2 = {"spawn_s": spawn_s}
    for r, res in enumerate(ranks):
        want = one["f32"]["terms"][0]
        got = res["f32"]["terms"][0]
        terms_rel = max(abs(got[k] - want[k]) / abs(want[k])
                        for k in want if k.startswith("loss_"))
        state_rel, worst = max_rel_state(res["f32"]["state"],
                                         one["f32"]["state"])
        bf16_rel = max(abs(g["loss_total"] - w["loss_total"])
                       / abs(w["loss_total"]) for g, w in
                       zip(res["bf16"]["terms"], one["bf16"]["terms"]))
        dp2[f"rank{r}"] = {
            "f32_loss_rel": terms_rel, "f32_state_rel": state_rel,
            "f32_worst_tensor": worst, "bf16_loss_rel": bf16_rel,
            "launches": [res["f32"]["launches"], res["bf16"]["launches"]],
            "bf16_step_ms_median": statistics.median(res["bf16"]["ms"])}
        log(f"[dp2] rank {r} of 2 (gloo, both on cuda:0): f32 B=8 one step "
            f"loss terms worst rel {terms_rel:.3g}, state worst "
            f"{state_rel:.3g}·max|p| ({worst}); bf16 B=32 {DP_BF16_STEPS} "
            f"steps loss_total worst rel {bf16_rel:.3g}; ppn_warp_kernel "
            f"launches {res['f32']['launches']} + {res['bf16']['launches']};"
            f" bf16 step median {statistics.median(res['bf16']['ms']):.3f} "
            f"ms (16 rows) | {card}")
        if (terms_rel > 1e-5 or state_rel > 1e-5 or bf16_rel > 2e-3
                or res["f32"]["launches"] != 1
                or res["bf16"]["launches"] != DP_BF16_STEPS):
            raise AssertionError(f"two-rank step disagrees: {dp2}")
    dp2["one_process_bf16_step_ms_median"] = statistics.median(
        one["bf16"]["ms"])
    log(f"[dp2] one process on the joined batch: bf16 step median "
        f"{dp2['one_process_bf16_step_ms_median']:.3f} ms (32 rows); the "
        f"two ranks share one card, so their times say nothing of two cards "
        f"(spawn and both ranks {spawn_s:.1f} s) | {card}")
    del one, ranks, cases

    # ---- 20. export: the pipeline through torch.export, against Predictor --
    exp = export_phase(cfg, val, dev)
    log(f"[export] B=8 on the card: {exp['bytes']} bytes, export "
        f"{exp['export_s']:.1f} s, reload {exp['load_s']:.1f} s; on the "
        f"protocol's first 8 images valid equal to Predictor.predict's "
        f"{exp['valid_equal']} ({exp['persons']} persons), floats max ulp "
        f"{exp['max_ulp']}; median of 20 calls: exported "
        f"{exp['exported_ms_b8']:.3f} ms, Predictor.predict "
        f"{exp['predict_ms_b8']:.3f} ms; post kernel launches in the "
        f"exported call {exp['post_launches_exported']}; plain post-process "
        f"at B=8, bounded NMS {exp['plain_post_bounded_ms_b8']:.3f} ms, "
        f"early exit {exp['plain_post_early_exit_ms_b8']:.3f} ms | {card}")
    if not exp["valid_equal"] or exp["max_ulp"] > ULP_LIMIT:
        raise AssertionError(f"exported pipeline disagrees: {exp}")

    # ---- 21. --pretrained: a run-time torchvision state dict ----------------
    pre = pretrained_phase()
    log(f"[pretrained] apps/train.main --pretrained: backbone equal to the "
        f"file's {pre['tensors']} tensors before step 1 "
        f"{pre['equal_before_step_1']}; loss_total over 2 steps "
        f"{[round(v, 4) for v in pre['losses']]}")
    if (not pre["equal_before_step_1"] or len(pre["losses"]) != 2
            or not all(math.isfinite(v) for v in pre["losses"])):
        raise AssertionError(f"--pretrained: {pre}")

    # ---- 22. profiling and debug --------------------------------------------
    prof = profiling_phase(cfg, val, dev)
    prof["post_graph_ms_b1"] = times[1][0]
    log(f"[profile] trace of one B=8 predict: {prof['kernels_in_trace']} "
        f"kernels, ppn_post_kernel {prof['post_in_trace']} "
        f"({prof['post_trace_us']} µs); device_latency_ms of the post "
        f"kernel's wrapper at B=1 {prof['post_device_latency_ms_b1']:.4f} ms "
        f"(the wrapper's host time {prof['post_wrapper_host_us_b1']:.1f} µs "
        f"a call; CUDA-graph replay, phase 6: {times[1][0]:.4f} ms) | {card}")
    log(f"[debug] NaN image: passes unchecked {prof['nan_passes_unchecked']}"
        f"; under debug.checking() raised: {prof['checking_raised']!r}")
    if (not prof["post_in_trace"] or not prof["checking_raised"]
            or not prof["nan_passes_unchecked"]):
        raise AssertionError(f"profiling/debug: {prof}")

    # ---- 23. native decode: enlarged JPEGs, evaluate and video CLIs --------
    native = native_phase(Predictor.from_npz(cfg, SNAPSHOT).model, card)

    # ---- 24. the K-step loop: bitwise against per-step calls ---------------
    kstep = k_step_phase(cfg, cache, dev, card)

    # ---- 25. the capacity-sharded cache on two ranks, K=2 Trainer ----------
    sharded = sharded_phase(cfg, cache, card)

    # ---- 26. the benchmark suite and the headline ---------------------------
    bench = bench_phase(card)

    # ---- 27. parity leftovers: loader workers, TensorBoard, num_params ------
    leftovers = leftovers_phase(cfg, dev, card)

    # ---- 28. the model family: ResNet-34/50 and the 224² config -----------
    family = family_phase(images, fixed, {
        "post_ms": {b: times[b][0] for b in (1, B)}, "warp_ms": w_ms,
        "warp_bound_ms": w_bound, "predict_ms": med,
        "video": videos["overlap"]}, card)
    worst_ulp = max(worst_ulp, family["post_max_ulp"])
    worst_err = max(worst_err, family["post_max_abs_err"])
    warp_err = max(warp_err, family["warp"]["max_abs_err"])

    # ---- 29. the accuracy tools ---------------------------------------------
    tools = tools_phase(family.pop("overfit_ckpt"), fixed, card)

    # ---- 30. the stage profilers ---------------------------------------------
    split = split_tools_phase(dev, card)

    # ---- 31. report ---------------------------------------------------------
    k_ms, p_ms, bound, whole, eager_ms, call_us = times[B]
    k1_ms, p1_ms, bound1, whole1, eager1_ms, call1_us = times[1]
    log(json.dumps({"serving_slice": {
        "tta_pckh": tta_pckh, "tta_joints": tta_joints,
        "tta_launches": tta_launches, "tta_predict_calls": tcalls,
        "tta_predict_ms_b128": tta_med, "tta_img_per_s_b128": 1e3 * B / tta_med,
        "b1_latency": latency, "b1_split_ms": split, "server": server,
        "video": videos}}))
    log(json.dumps({"evaluation_slice": evaluation}))
    file_step = files["train"]["step_ms_median"]
    log(f"[files] train step on files, median {file_step:.3f} ms (host "
        f"clock, phase 9) beside the synthetic step's {step_med:.3f} ms "
        f"(CUDA events, phase 15) | {card}")
    log(json.dumps({"file_input_slice": files}))
    log(json.dumps({"ninth_slice": {
        "data_parallel_one_rank": dp1_report,
        "data_parallel_two_ranks": dp2, "export": exp, "pretrained": pre,
        "profiling": prof}}))
    log(json.dumps({"eleventh_slice": {
        "native_decode": native, "k_step": kstep, "sharded_cache": sharded}}))
    log(json.dumps({"bench_suite": bench}))
    log(json.dumps({"parity_leftovers": leftovers}))
    log(json.dumps({"model_family": family}))
    log(json.dumps({"accuracy_tools": tools}))
    log(json.dumps({"stage_profilers": split}))
    log(card)   # the nvidia-smi name,power.limit line, as it prints it
    log(json.dumps({"kernels": [{
        "name": "ppn_post_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/post.cu",
        "replaces": "ppn_tpu/ops/pallas_post_packed.py:584",
        "also_replaces": "ppn_tpu/ops/pallas_post.py:292",
        "launches": launches, "max_abs_err": worst_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "ms_by": "CUDA graph replay of 50 launches",
        "ms_eager": eager_ms, "ms_eager_b1": eager1_ms,
        "host_us_per_call": call_us, "host_us_per_call_b1": call1_us,
        "bound_held_to": "bytes the main-path map needs",
        "bound_ms_whole_map": whole,
        "decisions_equal": True, "max_ulp": worst_ulp,
        "batch": B, "ms_b1": k1_ms, "plain_ms_b1": p1_ms,
        "bound_ms_b1": bound1, "bound_ms_b1_whole_map": whole1,
        "stage_us_b1": post_stages["main", 1],
        "stage_us_b128": post_stages["main", B],
        "stage_us_normal_b1": post_stages["normal", 1],
        "stage_us_normal_b128": post_stages["normal", B],
        "predict_ms_b128": med,
        "img_per_s_b128": 1e3 * B / med, "forward_ms_b128": fwd_ms,
        "launches_training_path": post_train_launches,
        "launches_evaluation_path": sum(
            v["launches"] for v in evaluation.values()),
        "launches_mesh_evaluate": dp1_report["post_launches_evaluate"],
        "launches_exported_pipeline": exp["post_launches_exported"],
        "launches_file_input": sum(
            files[k]["launches"] for k in FILE_PINS) + files["train"][
            "post_launches"] + files["video"]["launches"],
        "launches_native_files": (native["evaluate"]["launches"]
                                  + native["video"]["launches"]),
        "launches_bench_suite": {k: v[0] for k, v in bench["launches"].items()
                                 if v[0]},
        "launches_model_family": {
            "mpii_r50_384_predict": family["r50_predict"]["launches"],
            "train_cli_evaluate": {k: v["post_launches"] for k, v in
                                   family["train_cli"].items()},
            "video_224": family["video"]["launches"]},
        "launches_accuracy_tools": tools["launches"],
        "ms_7x7": {k: v["ms"] for k, v in family["post"].items()},
        "plain_ms_7x7": {k: v["plain_ms"] for k, v in family["post"].items()},
        "bound_ms_7x7": {k: v["bound_ms"] for k, v in family["post"].items()},
        "bound_ms_7x7_whole_map": {k: v["bound_ms_whole_map"]
                                   for k, v in family["post"].items()},
    }, {
        "name": "ppn_warp_kernel", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/warp.cu",
        "replaces": "ppn_tpu/ops/pallas_warp.py:166",
        "launches": warp_launches, "max_abs_err": warp_err,
        "ms": w_ms, "plain_ms": wp_ms, "bound_ms": w_bound,
        "bound_by": "bytes", "library_ms": None,
        "bound_held_to": "each input pixel read once, each output written once",
        "ms_by": "CUDA graph replay of 50 launches", "ms_eager": w_eager_ms,
        "batch": 32, "dtype": "bfloat16", "values_compared": warp_pixels,
        "train_step_ms_b32": step_med,
        "train_img_per_s_b32": 1e3 * bs / step_med,
        "train_stage_ms": stages, "overfit_first": curve[0],
        "overfit_last10_mean": tail,
        "launches_data_parallel_one_rank": dp1_report["warp_launches"],
        "launches_per_rank_two_ranks": [
            dp2[f"rank{r}"]["launches"] for r in (0, 1)],
        "launches_file_training": files["train"]["warp_launches"],
        "launches_per_k_step_call": kstep["warp_launches_per_call"],
        "launches_sharded_k_step_per_rank": [
            sharded[f"rank{r}"]["launches"] for r in (0, 1)],
        "launches_bench_suite": {k: v[1] for k, v in bench["launches"].items()
                                 if v[1]},
        "launches_parity_leftovers": leftovers["warp_launches"],
        "ms_b128": w128_ms, "plain_ms_b128": wp128_ms,
        "bound_ms_b128": w128_bound,
        "launches_model_family_train_cli": {
            k: v["warp_launches"] for k, v in family["train_cli"].items()},
        "ms_224_b32": family["warp"]["ms"],
        "plain_ms_224_b32": family["warp"]["plain_ms"],
        "bound_ms_224_b32": family["warp"]["bound_ms"],
        "launches_split_tools": split["launches"]["train_split"][1],
    }, {
        "name": "ppn_bn_*", "route": "cuda",
        "source": "ppn_tpu_torch/csrc/batch_norm.cu",
        "replaces": None,
        "launches_per_k_step_call": kstep["bn_launches_per_call"],
        "batch_norm_layers": kstep["bn_layers"],
        "ms": bn["ms_forward"] + bn["ms_backward"],
        "ms_forward": bn["ms_forward"], "ms_backward": bn["ms_backward"],
        "bound_ms": bn["bound_ms_forward"] + bn["bound_ms_backward"],
        "bound_by": "bytes", "library_ms": bn["library_ms"],
        "library": "PyTorch's SyncBatchNorm primitives and a separate ReLU",
        "plain_ms": bn["plain_ms"], "ms_layer_eager": bn["ms_layer_eager"],
        "ms_by": "CUDA graph replay of 20 forward and 20 backward calls",
        "shape": "B=128 64x192x192 bf16, ReLU", "worst": bn["worst"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
