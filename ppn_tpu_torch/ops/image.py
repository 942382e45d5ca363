"""Affine matrices, the separable affine warp and the bilinear resize
(port of ``ppn_tpu/ops/image.py``).

``affine_warp_separable_plain`` is the plain PyTorch version of
``ppn_warp_kernel`` (``csrc/warp.cu``): the CPU path, and the version the
kernel is held against on the card. It computes what the JAX package's
``affine_warp_separable`` computes for each image of a batch — two 1-D
hat-kernel resampling passes (Catmull–Smith) with bf16 weights and pixels,
f32 sums, a bf16 rounding between the passes and zero outside the source
frame — but in tap form: each hat row has at most two non-zero taps,
``floor(u)`` and ``floor(u) + 1``, so it gathers those two instead of
building the dense (H, W, W) weight tensor. Every product of two bf16
values is exact in f32 and at most two are non-zero, so each sum rounds
once, in any order, as the dense einsum's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_affine(center_in, center_out, angle_rad, scale, translate,
                flip=False):
    """(..., 2, 3) OUTPUT→INPUT matrices for rotate/scale/translate/flip
    about centers, plus the matching forward (INPUT→OUTPUT) matrices for
    keypoints. Batched over the leading dims of ``angle_rad``/``scale``.

    center_in, center_out, translate: (..., 2) (x, y) pixels;
    scale: output pixels per input pixel (> 1 zooms in).
    """
    cos = torch.cos(angle_rad)
    sin = torch.sin(angle_rad)
    fsign = torch.where(torch.as_tensor(flip, device=cos.device), -1.0, 1.0)

    # forward: p_out = R·S·F·(p_in − c_in) + c_out + t
    a = scale * cos * fsign
    b = -scale * sin
    c = scale * sin * fsign
    d = scale * cos
    tx = (-a * center_in[..., 0] - b * center_in[..., 1]
          + center_out[..., 0] + translate[..., 0])
    ty = (-c * center_in[..., 0] - d * center_in[..., 1]
          + center_out[..., 1] + translate[..., 1])
    fwd = torch.stack([torch.stack([a, b, tx], -1),
                       torch.stack([c, d, ty], -1)], -2)
    # backward (what the warp needs): invert the 2×2 + offset
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    bwd = torch.stack([torch.stack([ia, ib, -ia * tx - ib * ty], -1),
                       torch.stack([ic, id_, -ic * tx - id_ * ty], -1)], -2)
    return bwd, fwd


def apply_affine_points(fwd: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply forward (*S, 2, 3) matrices to (*S, ..., 2) xy points."""
    extra = pts.dim() - 1 - (fwd.dim() - 2)
    f = fwd.reshape(*fwd.shape[:-2], *([1] * extra), 2, 3)
    x = f[..., 0, 0] * pts[..., 0] + f[..., 0, 1] * pts[..., 1] + f[..., 0, 2]
    y = f[..., 1, 0] * pts[..., 0] + f[..., 1, 1] * pts[..., 1] + f[..., 1, 2]
    return torch.stack([x, y], dim=-1)


def _hat_bf16(u: torch.Tensor) -> torch.Tensor:
    """bf16(max(0, 1 − |u|)) held in f32."""
    return torch.clamp_min(1.0 - u.abs(), 0.0).to(torch.bfloat16).float()


def _warp_coefficients(matrices: torch.Tensor):
    """Per-image (a, b, c, d, e, f) of (B, 2, 3) OUTPUT→INPUT matrices,
    with the degenerate-``e`` guard of the JAX package (near ±90°
    rotations; outside the ±40° augmentation range)."""
    m = matrices.to(torch.float32)
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    e = torch.where(torch.abs(e) < 1e-3,
                    torch.sign(e) * 1e-3 + (e == 0).float() * 1e-3, e)
    return a, b, c, d, e, f


def _two_taps(src: torch.Tensor, u: torch.Tensor, dim: int, size: int):
    """Σ over the taps k ∈ {floor(u), floor(u)+1} inside [0, size) of
    bf16 hat(u − k) · src[k along ``dim``], in f32. ``src`` holds bf16
    values in f32 (B, H, W, C); ``u`` is (B, H, W)."""
    k0 = torch.floor(u)
    out = None
    for i in (0, 1):
        k = k0 + i
        w = _hat_bf16(u - k)
        # test k against the frame in float: zoom-outs push floor far out
        w = torch.where((k >= 0) & (k <= size - 1), w, 0.0)
        idx = k.clamp(0, size - 1).long()[..., None].expand_as(src)
        term = w[..., None] * src.gather(dim, idx)
        out = term if out is None else out + term
    return out


def affine_warp_separable_plain(images: torch.Tensor,
                                matrices: torch.Tensor) -> torch.Tensor:
    """Batched same-size affine warp, the plain version of ``ppn_warp_kernel``.

    images:   (B, H, W, C) float32 or bfloat16, NHWC
    matrices: (B, 2, 3) OUTPUT→INPUT affines (``make_affine``'s bwd)
    Returns (B, H, W, C) in the input dtype, zero outside the source frame.
    """
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"warp takes float32 or bfloat16, got {images.dtype}")
    B, H, W, C = images.shape
    dev = images.device
    a, b, c, d, e, f = _warp_coefficients(matrices)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)

    # pass 1, horizontal: tmp[y, x'] = in[y, r·x' + t(y)]
    r = a - b * d / e
    t_y = (b / e)[:, None] * ys + (c - b * f / e)[:, None]        # (B, H)
    xi = r[:, None, None] * xs + t_y[:, :, None]                  # (B, H, W)
    px = images.to(torch.bfloat16).float()
    tmp16 = _two_taps(px, xi, 2, W).to(torch.bfloat16).float()

    # pass 2, vertical: out[y, x] = tmp[e·y + (d·x + f), x]
    u_x = d[:, None] * xs + f[:, None]                            # (B, W)
    yi = e[:, None, None] * ys[:, None] + u_x[:, None, :]         # (B, H, W)
    return _two_taps(tmp16, yi, 1, H).to(images.dtype)


def resize_bilinear(image: torch.Tensor, out_size) -> torch.Tensor:
    """(..., H, W, C) float → (..., H_out, W_out, C) bilinear resize, the
    port of the JAX package's ``resize_bilinear`` (the video path's
    720p → insize). ``jax.image.resize(..., "bilinear")`` widens its
    triangle filter by the scale when it downscales (an antialiasing
    low-pass), which is ``F.interpolate``'s ``antialias=True``; without it
    the taps are plain bilinear and the result differs."""
    *lead, H, W, C = image.shape
    h, w = out_size
    x = image.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h, w), mode="bilinear", antialias=True,
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, C)
