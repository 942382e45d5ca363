"""Build, binding and wrapper of ``ppn_post_kernel`` (``csrc/post.cu``), the
fused post-process on Hopper that replaces the two TPU Pallas kernels
``ppn_tpu/ops/pallas_post.py`` and ``ppn_tpu/ops/pallas_post_packed.py``.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface at first use (``build/ppn_tpu_torch/libppn_post.so``) and
loaded with ctypes. The kernel launches on the current PyTorch stream; the
wrapper allocates the outputs and raises on any CUDA error. Nothing here
runs on a CPU tensor: ``ops/postprocess.py`` sends those to the plain
version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ppn_tpu_torch.configs import PPNConfig
from ppn_tpu_torch.ops.parse import People

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "post.cu"
LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "ppn_tpu_torch"
            / "libppn_post.so")
# --fmad=false keeps every decision product and sum rounded on its own, as
# in the plain version; no fast math (σ uses the full-precision expf).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

# Launches of ppn_post_kernel in this process (one per wrapper call).
LAUNCHES = 0

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def build(force: bool = False) -> str:
    """Compile ``post.cu`` unless the library is newer than the source.
    Returns nvcc's report (ptxas registers and shared memory), or "" when
    the library was already up to date."""
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime):
        return ""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)   # atomic: no process loads a half-written .so
    return proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ppn_post_launch.argtypes = (
            [p] * 7 + [i] * 10 + [f] * 6 + [i, i, p, p])
        lib.ppn_post_launch.restype = i
        lib.ppn_post_error_string.argtypes = [i]
        lib.ppn_post_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def postprocess_batch_cuda(cfg: PPNConfig, feature_map: torch.Tensor) -> People:
    """(B, H', W', C) f32 CUDA feature map → batched People, one launch."""
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
        edges = (ctypes.c_int32 * (2 * L))(*[v for e in cfg.edges for v in e])
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppn_post_launch(
            fm.data_ptr(), kp_cell.data_ptr(), kp_box.data_ptr(),
            kp_score.data_ptr(), kp_valid.data_ptr(), valid.data_ptr(),
            num_kp.data_ptr(), dev.index or 0, B, H, W, cfg.num_channels,
            K1, L, Hl, Wl, P, sx, sy, float(img_w), float(img_h),
            cfg.detection_thresh, cfg.nms_thresh, cfg.min_num_keypoints,
            int(cfg.size_activation == "exp"), edges, stream)
        if err != 0:
            raise RuntimeError(
                "ppn_post_kernel launch failed: "
                f"{lib.ppn_post_error_string(err).decode()} ({err})")
        LAUNCHES += 1
    return People(kp_cell=kp_cell, kp_box=kp_box, kp_score=kp_score,
                  kp_valid=kp_valid.view(torch.bool),
                  valid=valid.view(torch.bool), num_kp=num_kp)
