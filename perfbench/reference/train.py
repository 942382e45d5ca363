"""The plain reference of one training step, in float32: the augmentation
(draws, the separable affine warp, the colour suite, the GT transform), the
target encoding, the five-term PPN loss, its gradients by autograd and
SGD with momentum and masked weight decay on the configured schedule.

Frozen copies, computed in float32 throughout, of the program's
``ops/augment.py`` (``sample_params``, ``apply_color``, ``transform_gt``),
``ops/image.py`` (``make_affine``, ``apply_affine_points``, the two-tap
warp without its bfloat16 roundings), ``ops/encode.py``,
``train/loss.py`` and ``train/steps.py`` (``make_lr_schedule``,
``sgd_update``) at commit 6c798b19f2f81ac884339f9f662eb9e6d03a12e7. The
augmentation draws come from a ``torch.Generator`` seeded as the
configuration's step seeds its own, drawn in the same order and shapes,
so both sides warp by the same matrices.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as refmodel
from perfbench.reference.post import decode, iou_cxcywh

Tensors = Dict[str, torch.Tensor]


# ---- augmentation ------------------------------------------------------------

def make_affine(center_in, center_out, angle, scale, translate, flip):
    cos, sin = torch.cos(angle), torch.sin(angle)
    fsign = torch.where(flip, -1.0, 1.0)
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
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    bwd = torch.stack([torch.stack([ia, ib, -ia * tx - ib * ty], -1),
                       torch.stack([ic, id_, -ic * tx - id_ * ty], -1)], -2)
    return bwd, fwd


def apply_affine_points(fwd: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    extra = pts.dim() - 1 - (fwd.dim() - 2)
    f = fwd.reshape(*fwd.shape[:-2], *([1] * extra), 2, 3)
    x = f[..., 0, 0] * pts[..., 0] + f[..., 0, 1] * pts[..., 1] + f[..., 0, 2]
    y = f[..., 1, 0] * pts[..., 0] + f[..., 1, 1] * pts[..., 1] + f[..., 1, 2]
    return torch.stack([x, y], dim=-1)


def sample_params(g, d: dict, generator: torch.Generator,
                  bboxes: torch.Tensor, valid: torch.Tensor):
    """(bwd, fwd, scale, flip, color) of one batch; the draws of the
    configuration's augmentation, in its order."""
    H, W = g.insize
    B = valid.shape[0]
    dev = bboxes.device
    u = torch.rand((B, 11), generator=generator, device=dev)
    gum = torch.rand(tuple(valid.shape), generator=generator, device=dev)

    def uniform(col, lo, hi):
        return u[:, col] * (hi - lo) + lo

    angle = uniform(0, -d["rotate_deg"], d["rotate_deg"]) * (math.pi / 180.0)
    scale = uniform(1, d["scale_min"], d["scale_max"])
    trans = torch.stack(
        [uniform(2, -d["translate_frac"], d["translate_frac"]),
         uniform(3, -d["translate_frac"], d["translate_frac"])], -1
    ) * torch.tensor([W, H], dtype=torch.float32, device=dev)
    flip = u[:, 4] < d["hflip_prob"]
    center = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32,
                          device=dev).expand(B, 2)
    valid_b = valid.bool()
    logits = torch.where(valid_b, 0.0, -1e9)
    tiny = torch.finfo(torch.float32).tiny
    pidx = torch.argmax(logits - torch.log(-torch.log(gum.clamp_min(tiny))),
                        dim=1)
    pbox = bboxes[torch.arange(B, device=dev), pidx].float()
    person_dim = torch.clamp_min(torch.maximum(pbox[:, 2], pbox[:, 3]), 1.0)
    frac = uniform(5, d["crop_frac_min"], d["crop_frac_max"])
    zoom = torch.clamp(frac * min(H, W) / person_dim, 0.25, 4.0)
    do_crop = (u[:, 6] < d["crop_prob"]) & valid_b.any(dim=1)
    center_in = torch.where(do_crop[:, None], pbox[:, :2], center)
    scale = torch.where(do_crop, zoom * scale, scale)
    bwd, fwd = make_affine(center_in, center, angle, scale, trans, flip)
    one = torch.ones(B, device=dev)
    color = torch.stack([
        1.0 + uniform(7, -d["color_jitter"], d["color_jitter"]),
        1.0 + uniform(8, -d["color_jitter"], d["color_jitter"]),
        (1.0 + uniform(9, -d["saturation_jitter"], d["saturation_jitter"])
         if d["saturation_jitter"] > 0 else one),
        (1.0 + uniform(10, -d["sharpness_jitter"], d["sharpness_jitter"])
         if d["sharpness_jitter"] > 0 else one),
    ], dim=-1)
    return bwd, fwd, scale, flip, color


def _two_taps(src, u, dim, size):
    k0 = torch.floor(u)
    out = None
    for i in (0, 1):
        k = k0 + i
        w = torch.clamp_min(1.0 - (u - k).abs(), 0.0)
        w = torch.where((k >= 0) & (k <= size - 1), w, 0.0)
        idx = k.clamp(0, size - 1).long()[..., None].expand_as(src)
        term = w[..., None] * src.gather(dim, idx)
        out = term if out is None else out + term
    return out


def warp(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float32 warped by (B, 2, 3) OUTPUT→INPUT matrices in two
    1-D hat-kernel passes (horizontal, then vertical), zero outside."""
    B, H, W, C = images.shape
    dev = images.device
    m = matrices.float()
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    e = torch.where(torch.abs(e) < 1e-3,
                    torch.sign(e) * 1e-3 + (e == 0).float() * 1e-3, e)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    r = a - b * d / e
    t_y = (b / e)[:, None] * ys + (c - b * f / e)[:, None]
    xi = r[:, None, None] * xs + t_y[:, :, None]
    tmp = _two_taps(images, xi, 2, W)
    u_x = d[:, None] * xs + f[:, None]
    yi = e[:, None, None] * ys[:, None] + u_x[:, None, :]
    return _two_taps(tmp, yi, 1, H)


def _smooth3x3(img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape[1:3]
    rows = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    p = img[:, rows][:, :, cols]
    acc = 4.0 * img
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + p[:, dy:dy + H, dx:dx + W]
    return acc / 13.0


def apply_color(d: dict, out: torch.Tensor, color: torch.Tensor):
    b, c, s, sh = (color[:, i].view(-1, 1, 1, 1) for i in range(4))
    mean = out.mean(dim=(1, 2), keepdim=True)
    out = ((out - mean) * c + mean) * b
    if d["saturation_jitter"] > 0:
        gray = (out[..., 0:1] * 0.299 + out[..., 1:2] * 0.587
                + out[..., 2:3] * 0.114)
        out = gray + (out - gray) * s
    if d["sharpness_jitter"] > 0:
        smooth = _smooth3x3(out)
        out = smooth + (out - smooth) * sh
    return torch.clamp(out, 0.0, 1.0)


def flip_permutation(g) -> list:
    perm = list(range(g.num_keypoints))
    for a, b in g.flip_pairs:
        perm[a - 1], perm[b - 1] = perm[b - 1], perm[a - 1]
    return perm


def augment(g, d: dict, generator, batch: Tensors,
            precision: str = "float32") -> Tensors:
    """uint8 batch → augmented float32 images and transformed GT; the
    images rounded to ``precision`` after the warp and the colour suite
    (``"nudge"``: moved up one float32 ulp there; ``"image16"``: rounded
    to bfloat16 there, and nowhere else)."""
    bwd, fwd, scale, flip, color = sample_params(
        g, d, generator, batch["bboxes"], batch["valid"])
    img = batch["image"].float() / 255.0
    out = refmodel.rounded(warp(img, bwd), precision)
    out = refmodel.rounded(apply_color(d, out, color), precision)
    if precision == "nudge":       # every pixel one float32 ulp up
        out = torch.nextafter(out, torch.full_like(out, 2.0))
    if precision == "image16":     # the augmented image in bfloat16
        out = out.to(torch.bfloat16).float()
    H, W = g.insize
    kp = apply_affine_points(fwd, batch["keypoints"].float())
    centers = apply_affine_points(fwd, batch["bboxes"][..., :2].float())
    wh = batch["bboxes"][..., 2:].float() * scale[:, None, None]
    perm = flip_permutation(g)
    fl = flip.view(-1, 1, 1)
    kp = torch.where(fl[..., None], kp[:, :, perm], kp)
    vis = torch.where(fl, batch["visible"][:, :, perm], batch["visible"])
    inb = ((kp[..., 0] >= 0) & (kp[..., 0] < W)
           & (kp[..., 1] >= 0) & (kp[..., 1] < H))
    return {"image": out, "keypoints": kp, "visible": vis.bool() & inb,
            "bboxes": torch.cat([centers, wh], dim=-1),
            "valid": batch["valid"].bool()}


# ---- targets and loss ------------------------------------------------------

def encode(g, keypoints, visible, bboxes, valid) -> Tensors:
    """GT → target grids delta, tx, ty, tw, th (B, H', W', K+1) and te
    (B, H', W', L, H_l, W_l); two persons on one (cell, class): the highest
    person index writes the box fields."""
    B, P, K = visible.shape
    K1 = g.num_classes
    H, W = g.outsize
    Hl, Wl = g.local_grid_size
    L = g.num_limbs
    sy, sx = g.stride
    img_h, img_w = g.insize
    dev = keypoints.device
    f32 = torch.float32
    centers = torch.cat([bboxes[:, :, None, :2], keypoints], dim=2)
    inst_wh = bboxes[..., 2:4] * g.instance_scale
    part_side = g.parts_scale * torch.sqrt(
        (torch.square(inst_wh[..., 0]) + torch.square(inst_wh[..., 1]))
        .double()).float()
    part_wh = part_side[:, :, None, None].expand(B, P, K, 2)
    sizes = torch.cat([inst_wh[:, :, None, :], part_wh], dim=2)
    ok = torch.cat([valid[:, :, None], visible & valid[:, :, None]], dim=2)
    gx, gy = centers[..., 0] / sx, centers[..., 1] / sy
    ix, iy = torch.floor(gx).long(), torch.floor(gy).long()
    ok = ok & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    iy_s, ix_s = torch.where(ok, iy, H), torch.where(ok, ix, W)
    bi = torch.arange(B, device=dev)[:, None, None]
    cls = torch.arange(K1, device=dev)[None, None, :]
    cell = ((bi * (H + 1) + iy_s) * (W + 1) + ix_s) * K1 + cls
    n_cells = B * (H + 1) * (W + 1) * K1
    delta = torch.zeros(n_cells, dtype=f32, device=dev).scatter_reduce(
        0, cell.reshape(-1), ok.to(f32).reshape(-1), "amax")
    delta = delta.view(B, H + 1, W + 1, K1)[:, :H, :W]
    person = torch.arange(P, device=dev)[None, :, None].expand(B, P, K1)
    winner = torch.full((n_cells,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(
        0, cell.reshape(-1), torch.where(ok, person, -1).reshape(-1), "amax")
    winner = winner.view(B, H + 1, W + 1, K1)[:, :H, :W]
    box_vals = torch.stack([gx - ix.to(f32), gy - iy.to(f32),
                            sizes[..., 0] / img_w, sizes[..., 1] / img_h], -1)
    picked = box_vals[bi[..., None], winner.clamp_min(0), cls[:, None]]
    picked = torch.where((winner >= 0)[..., None], picked, 0.0)
    tx, ty, tw, th = picked.unbind(-1)
    src = torch.tensor([e[0] for e in g.edges], device=dev)
    dst = torch.tensor([e[1] for e in g.edges], device=dev)
    iy_src, ix_src = iy[:, :, src], ix[:, :, src]
    dy = iy[:, :, dst] - iy_src + Hl // 2
    dx = ix[:, :, dst] - ix_src + Wl // 2
    pair_ok = (ok[:, :, src] & ok[:, :, dst]
               & (dy >= 0) & (dy < Hl) & (dx >= 0) & (dx < Wl))
    iy_e, ix_e = torch.where(pair_ok, iy_src, H), torch.where(pair_ok, ix_src, W)
    lidx = torch.arange(L, device=dev)[None, None, :]
    flat = ((((bi * (H + 1) + iy_e) * (W + 1) + ix_e) * L + lidx) * Hl
            + dy.clamp(0, Hl - 1)) * Wl + dx.clamp(0, Wl - 1)
    te = torch.zeros(B * (H + 1) * (W + 1) * L * Hl * Wl, dtype=f32,
                     device=dev).scatter_reduce(
        0, flat.reshape(-1), pair_ok.to(f32).reshape(-1), "amax")
    te = te.view(B, H + 1, W + 1, L, Hl, Wl)[:, :H, :W]
    return {"delta": delta, "tx": tx, "ty": ty, "tw": tw, "th": th, "te": te}


def limb_mask(g, delta: torch.Tensor) -> torch.Tensor:
    H, W = g.outsize
    Hl, Wl = g.local_grid_size
    ch, cw = Hl // 2, Wl // 2
    src = [s for s, _ in g.edges]
    dst = [d for _, d in g.edges]
    padded = F.pad(delta[..., dst], (0, 0, cw, cw, ch, ch))
    windows = torch.stack([padded[:, dy:dy + H, dx:dx + W, :]
                           for dy in range(Hl) for dx in range(Wl)], dim=-1)
    windows = windows.reshape(*windows.shape[:-1], Hl, Wl)
    return torch.maximum(delta[..., src][..., None, None], windows)


def loss(g, fm: torch.Tensor, t: Tensors) -> Tensors:
    """The five weighted terms and ``loss_total``, averaged over the batch."""
    act, props = decode(g, fm)
    B = fm.shape[0]
    sy, sx = g.stride
    img_h, img_w = g.insize
    delta = t["delta"]
    H, W = g.outsize
    iy = torch.arange(H, dtype=torch.float32, device=fm.device)[:, None, None]
    ix = torch.arange(W, dtype=torch.float32, device=fm.device)[None, :, None]
    with torch.no_grad():
        gt = torch.stack([(ix + t["tx"]) * sx, (iy + t["ty"]) * sy,
                          t["tw"] * img_w, t["th"] * img_h], dim=-1)
        iou_t = iou_cxcywh(props.boxes.detach(), gt)
    eps = 1e-6
    terms = {
        "loss_resp": torch.sum(torch.square(delta - act.resp)),
        "loss_iou": torch.sum(delta * torch.square(iou_t - act.conf)),
        "loss_coor": torch.sum(delta * (torch.square(t["tx"] - act.x)
                                        + torch.square(t["ty"] - act.y))),
        "loss_size": torch.sum(delta * (
            torch.square(torch.sqrt(torch.clamp_min(t["tw"], eps))
                         - torch.sqrt(torch.clamp_min(act.w, eps)))
            + torch.square(torch.sqrt(torch.clamp_min(t["th"], eps))
                           - torch.sqrt(torch.clamp_min(act.h, eps))))),
    }
    limb_sq = torch.square(t["te"] - act.e)
    if g.limb_loss_mode == "paired":
        terms["loss_limb"] = torch.sum(limb_mask(g, delta) * limb_sq)
    else:
        terms["loss_limb"] = torch.sum(limb_sq)
    terms = {k: v / B for k, v in terms.items()}
    terms["loss_total"] = (
        g.lambda_resp * terms["loss_resp"] + g.lambda_iou * terms["loss_iou"]
        + g.lambda_coor * terms["loss_coor"]
        + g.lambda_size * terms["loss_size"]
        + g.lambda_limb * terms["loss_limb"])
    return terms


# ---- optimizer -------------------------------------------------------------

def learning_rate(t: dict, count: int) -> float:
    """The configured schedule at ``count`` steps taken: a linear warm-up
    joined to the cosine, constant or step decay, in float32."""
    f = np.float32
    lr, warm = f(t["learning_rate"]), t["warmup_steps"]
    if count < warm:
        return float(-lr * (f(1) - f(max(count, 0)) / f(warm)) + lr)
    count -= warm
    if t["lr_schedule"] == "constant":
        return float(lr)
    if t["lr_schedule"] == "cosine":
        decay = max(t["num_steps"], warm + 1) - warm
        c = f(min(count, decay))
        return float(lr * (f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay)))))
    v = lr
    for bound in sorted({int(t["num_steps"] * 0.6) - warm,
                         int(t["num_steps"] * 0.85) - warm}):
        if count >= bound:
            v = f(0.1) * v
    return float(v)


class Trainer:
    """The reference's training state: parameters and BatchNorm statistics
    (float32), momentum traces, the step count and the augmentation's
    generator, stepped one batch at a time."""

    def __init__(self, cfg: dict, weights: Tensors, seed: int, device,
                 precision: str = "float32"):
        from perfbench.reference.geometry import Geometry

        self.cfg, self.m, self.t = cfg, cfg["model"], cfg["train"]
        self.g = Geometry(self.m)
        self.precision = precision
        stats = set(refmodel.buffer_names(self.m))
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       for k, v in weights.items() if k not in stats}
        self.stats = {k: weights[k].detach().to(device, torch.float32).clone()
                      for k in stats}
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def resume(self, params: Tensors, trace: Tensors, count: int,
               generator_state: torch.Tensor) -> None:
        """Continue from a state that another stepper reached: parameters,
        momentum traces, steps taken and the augmentation generator's
        state."""
        dev = self.generator.device
        self.params = {k: params[k].detach().to(dev, torch.float32).clone()
                       for k in self.params}
        self.trace = {k: trace[k].detach().to(dev, torch.float32).clone()
                      for k in self.params}
        self.count = int(count)
        self.generator.set_state(generator_state)

    def step(self, batch: Tensors):
        """One step on a uint8 batch; returns the loss terms and the
        gradients as the optimizer receives them, by name."""
        aug = augment(self.g, self.cfg["data"], self.generator, batch,
                      self.precision)
        targets = encode(self.g, aug["keypoints"], aug["visible"],
                         aug["bboxes"], aug["valid"])
        leaves = {k: v.requires_grad_(True) for k, v in self.params.items()}
        fm = refmodel.forward(self.m, {**leaves, **self.stats}, aug["image"],
                              train=True, stats=self.stats,
                              precision=self.precision)
        terms = loss(self.g, fm, targets)
        names = list(leaves)
        grads = torch.autograd.grad(terms["loss_total"],
                                    [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        self._sgd(grads)
        return {k: v.detach() for k, v in terms.items()}, grads

    @torch.no_grad()
    def _sgd(self, grads: Tensors) -> None:
        t = self.t
        lr = learning_rate(t, self.count)
        for n, p in self.params.items():
            p.requires_grad_(False)
            g = grads[n] + t["weight_decay"] * p if p.ndim > 1 else grads[n]
            self.trace[n] = t["momentum"] * self.trace[n] + g
            p.add_(-lr * self.trace[n])
        self.count += 1
