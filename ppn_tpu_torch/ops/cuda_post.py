"""Build, binding and wrapper of ``ppn_post_kernel`` (``csrc/post.cu``), the
fused post-process on Hopper that replaces the two TPU Pallas kernels
``ppn_tpu/ops/pallas_post.py`` and ``ppn_tpu/ops/pallas_post_packed.py``.

The source is compiled by ``nvcc`` for ``sm_90a`` at first use
(``ops/cuda_build.py``) and loaded with ctypes. The kernel launches on the
current PyTorch stream; the wrapper allocates the outputs and raises on any
CUDA error. Nothing here runs on a CPU tensor: ``ops/postprocess.py`` sends
those to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops import cuda_build
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops import nms as nmsops
from ppn_tpu_torch.ops.parse import People, parse_batch, window_tables

SOURCE = "post.cu"

# Launches of ppn_post_kernel in this process (one per wrapper call).
LAUNCHES = 0

# The kernel's stages, in order; with ``stage_clocks`` thread 0 of each CTA
# stamps %globaltimer (ns) at entry and after the barrier closing each one.
STAGES = ("decode", "mask", "nms", "windows", "seeds", "walk", "write")

_lib = None


def build(force: bool = False) -> str:
    """Compile ``post.cu`` unless its library is up to date. Returns nvcc's
    report (ptxas registers and shared memory), or "" when it was."""
    return cuda_build.build([SOURCE], force)[SOURCE]


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ppn_post_launch.argtypes = (
            [p] * 7 + [i] * 10 + [f] * 6 + [i, i, p, p, p])
        lib.ppn_post_launch.restype = i
        lib.ppn_post_error_string.argtypes = [i]
        lib.ppn_post_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _edges(edges: tuple) -> ctypes.Array:
    """The (src, dst) limb pairs as the C array the launch reads."""
    return (ctypes.c_int32 * (2 * len(edges)))(*[v for e in edges for v in e])


def postprocess_batch_cuda(cfg: PPNConfig, feature_map: torch.Tensor,
                           stage_clocks: torch.Tensor | None = None) -> People:
    """(B, H', W', C) f32 CUDA feature map → batched People, one launch.

    ``stage_clocks``, a (B, len(STAGES) + 1) int64 tensor on the map's
    device, receives each CTA's stage timestamps (``stage_us`` reads them);
    None, the default, times nothing."""
    global LAUNCHES
    H, W = cfg.outsize
    Hl, Wl = cfg.local_grid_size
    K1, L, P = cfg.num_classes, cfg.num_limbs, cfg.max_instances
    fm = feature_map
    if fm.device.type != "cuda":
        raise ValueError(f"ppn_post_kernel needs a CUDA tensor, got {fm.device}")
    if fm.dtype != torch.float32:
        raise TypeError(f"ppn_post_kernel takes float32, got {fm.dtype}")
    if fm.dim() != 4 or tuple(fm.shape[1:]) != (H, W, cfg.num_channels):
        raise ValueError(f"feature map {tuple(fm.shape)} is not "
                         f"(B, {H}, {W}, {cfg.num_channels})")
    if not fm.is_contiguous():
        raise ValueError("ppn_post_kernel needs a contiguous feature map")
    if P > H * W:
        raise ValueError(f"max_instances {P} exceeds the {H * W} grid cells")
    B = fm.shape[0]
    dev = fm.device
    if stage_clocks is not None and (
            stage_clocks.dtype != torch.int64
            or stage_clocks.device != dev or not stage_clocks.is_contiguous()
            or tuple(stage_clocks.shape) != (B, len(STAGES) + 1)):
        raise ValueError(f"stage_clocks must be a contiguous int64 "
                         f"({B}, {len(STAGES) + 1}) tensor on {dev}")
    kp_cell = torch.empty((B, P, K1, 2), dtype=torch.int32, device=dev)
    kp_box = torch.empty((B, P, K1, 4), dtype=torch.float32, device=dev)
    kp_score = torch.empty((B, P, K1), dtype=torch.float32, device=dev)
    kp_valid = torch.empty((B, P, K1), dtype=torch.uint8, device=dev)
    valid = torch.empty((B, P), dtype=torch.uint8, device=dev)
    num_kp = torch.empty((B, P), dtype=torch.int32, device=dev)
    if B > 0:
        lib = _load()
        sy, sx = cfg.stride
        img_h, img_w = cfg.insize
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppn_post_launch(
            fm.data_ptr(), kp_cell.data_ptr(), kp_box.data_ptr(),
            kp_score.data_ptr(), kp_valid.data_ptr(), valid.data_ptr(),
            num_kp.data_ptr(), dev.index or 0, B, H, W, cfg.num_channels,
            K1, L, Hl, Wl, P, sx, sy, float(img_w), float(img_h),
            cfg.detection_thresh, cfg.nms_thresh, cfg.min_num_keypoints,
            int(cfg.size_activation == "exp"), _edges(tuple(cfg.edges)),
            None if stage_clocks is None else stage_clocks.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                "ppn_post_kernel launch failed: "
                f"{lib.ppn_post_error_string(err).decode()} ({err})")
        LAUNCHES += 1
    return People(kp_cell=kp_cell, kp_box=kp_box, kp_score=kp_score,
                  kp_valid=kp_valid.view(torch.bool),
                  valid=valid.view(torch.bool), num_kp=num_kp)


def stage_us(clocks: torch.Tensor) -> dict[str, float]:
    """Mean µs of each stage over the CTAs of a ``stage_clocks`` buffer."""
    d = clocks.double().diff(dim=1).mean(dim=0) / 1e3
    return dict(zip(STAGES, d.tolist()))


def output_bytes(cfg: PPNConfig) -> int:
    """Bytes of one image's People fields."""
    P, K1 = cfg.max_instances, cfg.num_classes
    return P * K1 * (2 * 4 + 4 * 4 + 4 + 1) + P * (1 + 4)


def needed_bytes(cfg: PPNConfig, feature_map: torch.Tensor) -> int:
    """Bytes ppn_post_kernel must move for this (B, H', W', C) map, each
    read once: the 6·K1 proposal channels of every cell; 4 bytes for each
    (image, cell, limb, offset) whose neighbour lies in the frame and
    either keeps a post-NMS score > 0 (no other destination can win) or
    belongs to a row the limb walk consults that holds such a destination
    (every in-frame logit of that row must be seen, since one NaN leaves
    the row without a winner); and the outputs. The post-NMS scores and the
    walk come from the plain version."""
    B = feature_map.shape[0]
    H, W = cfg.outsize
    N, K1 = H * W, cfg.num_classes
    dev = feature_map.device
    act, props = dec.decode(cfg, feature_map)
    nms = nmsops.nms_batch(cfg, props)
    kept = nms.score.reshape(B, N, K1)[:, :, [d for _, d in cfg.edges]] > 0.0
    _, nbrv, nbrc = window_tables(cfg)                            # (NW, N)
    inside = torch.from_numpy(nbrv).to(dev)[None, :, :, None]
    toward_kept = inside & kept[:, torch.from_numpy(nbrc).to(dev)]  # (B, NW, N, L)
    # the rows the walk consults: limb l from its source class's cell in
    # every slot where that keypoint is valid (its score is then > 0)
    ppl = parse_batch(cfg, act, props, nms)
    cell = ppl.kp_cell[..., 0].long() * W + ppl.kp_cell[..., 1].long()
    consulted = torch.zeros_like(kept)                             # (B, N, L)
    for l, (s, _) in enumerate(cfg.edges):
        b, q = torch.nonzero(ppl.kp_score[:, :, s] > 0.0, as_tuple=True)
        consulted[b, cell[b, q, s], l] = True
    scanned = consulted & toward_kept.any(dim=1)
    reads = toward_kept | (inside & scanned[:, None])
    return B * (N * 6 * K1 * 4 + output_bytes(cfg)) + 4 * int(reads.sum())
