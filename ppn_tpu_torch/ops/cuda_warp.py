"""Binding and wrapper of ``ppn_warp_kernel`` (``csrc/warp.cu``), the batched
affine warp of the training augmentation on Hopper; it replaces the TPU
Pallas kernel ``ppn_tpu/ops/pallas_warp.py`` (``affine_warp_batch_pallas``).

``affine_warp_batch`` sends a CUDA tensor to the kernel and a CPU tensor to
the plain version (``ops/image.py affine_warp_separable_plain``); there is
nothing in between. The kernel launches on the current PyTorch stream; the
wrapper allocates the output and raises on any CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from ppn_tpu_torch.ops import cuda_build
from ppn_tpu_torch.ops.image import affine_warp_separable_plain

SOURCE = "warp.cu"

# Launches of ppn_warp_kernel in this process (one per wrapper call on a
# CUDA tensor: a call under CUDA graph capture counts, its replays do not).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ppn_warp_launch.argtypes = [p, p, p] + [i] * 6 + [p]
        lib.ppn_warp_launch.restype = i
        lib.ppn_warp_error_string.argtypes = [i]
        lib.ppn_warp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def affine_warp_cuda(images: torch.Tensor,
                     matrices: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 or bf16 CUDA images warped by (B, 2, 3) OUTPUT→INPUT
    matrices, one launch; output in the input dtype."""
    global LAUNCHES
    if images.device.type != "cuda":
        raise ValueError(f"ppn_warp_kernel needs a CUDA tensor, got "
                         f"{images.device}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ppn_warp_kernel takes float32 or bfloat16, got "
                        f"{images.dtype}")
    if images.dim() != 4 or not 1 <= images.shape[3] <= 4:
        raise ValueError(f"images {tuple(images.shape)} are not (B, H, W, C)"
                         " with 1 ≤ C ≤ 4")
    B, H, W, C = images.shape
    if tuple(matrices.shape) != (B, 2, 3):
        raise ValueError(f"matrices {tuple(matrices.shape)} are not "
                         f"({B}, 2, 3)")
    if matrices.device != images.device:
        raise ValueError("images and matrices lie on different devices")
    images = images.contiguous()
    mats = matrices.to(torch.float32).contiguous()
    out = torch.empty_like(images)
    if B * H * W == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.ppn_warp_launch(
        images.data_ptr(), out.data_ptr(), mats.data_ptr(), B, H, W, C,
        int(images.dtype == torch.bfloat16), images.device.index or 0,
        stream)
    if err != 0:
        raise RuntimeError("ppn_warp_kernel launch failed: "
                           f"{lib.ppn_warp_error_string(err).decode()} "
                           f"({err})")
    LAUNCHES += 1
    return out


def affine_warp_batch(images: torch.Tensor,
                      matrices: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if images.device.type == "cuda":
        return affine_warp_cuda(images, matrices)
    if images.device.type == "cpu":
        return affine_warp_separable_plain(images, matrices)
    raise ValueError(f"no warp for device {images.device}")
