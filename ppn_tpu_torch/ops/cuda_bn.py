"""Binding and wrapper of the training-mode BatchNorm kernels ``ppn_bn_*``
(``csrc/batch_norm.cu``), forward and backward with the activation that
follows the layer folded in. They replace no TPU kernel: the JAX package
leaves BatchNorm to XLA (the source's header says why the port has one).

``batch_norm_train`` sends a CUDA tensor to the kernels, through
``BatchNormTrain`` (an autograd function whose backward is the kernels'
too), and a CPU tensor to the plain version, ``batch_norm_train_plain``,
which autograd differentiates; there is nothing in between. The kernels
launch on the current PyTorch stream; the wrappers allocate the outputs
and the workspace and raise on any CUDA error.

The plain version of the backward's arithmetic, ``grad_sums_plain`` and
``backward_plain``, is what the card tests hold the backward kernels to;
the CPU tests hold it to autograd through ``batch_norm_train_plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ppn_tpu_torch.ops import cuda_build
from ppn_tpu_torch.parallel.mesh import all_reduce_sum

SOURCE = "batch_norm.cu"

# The activations a layer may fold in, by the kernels' code.
ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.1            # the head's LeakyReLU

# Kernel launches of ppn_bn_* in this process: 3 per forward (partial sums,
# their reduction, the apply), 3 per backward (2 when no input gradient is
# asked for). Counted per call: a call under CUDA graph capture counts, its
# replays do not.
LAUNCHES = 0

_lib = None
_partials: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.ppn_bn_partials.argtypes = [ll, i, i, i]
        lib.ppn_bn_partials.restype = i
        lib.ppn_bn_forward.argtypes = [p] * 8 + [ll, i, f, f, f] + [i] * 4 + [p]
        lib.ppn_bn_forward.restype = i
        lib.ppn_bn_backward.argtypes = [p] * 10 + [ll, i, f] + [i] * 4 + [p]
        lib.ppn_bn_backward.restype = i
        lib.ppn_bn_error_string.argtypes = [i]
        lib.ppn_bn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def activate(y: torch.Tensor, act) -> torch.Tensor:
    """``act`` applied to a BatchNorm output in its dtype, eagerly."""
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, negative_slope=LEAKY_SLOPE)
    raise ValueError(f"no activation {act!r}; one of {list(ACTS)}")


# ---- the plain version --------------------------------------------------------

def stats_plain(xf: torch.Tensor) -> torch.Tensor:
    """[Σx (C), Σx² (C), count] of an f32 (N, C, H, W) map."""
    c = xf.shape[1]
    return torch.cat([xf.sum(dim=(0, 2, 3)),
                      torch.square(xf).sum(dim=(0, 2, 3)),
                      xf.new_full((1,), xf.numel() // c)])


def channel_stats_plain(sums: torch.Tensor, eps: float):
    """(mean, v, var) from the sums: ``v = E[x²] − E[x]²``, ``var`` it
    clipped at 0."""
    c = (sums.shape[0] - 1) // 2
    s1, s2, count = sums.split([c, c, 1])
    mean = s1 / count
    v = s2 / count - torch.square(mean)
    return mean, v, torch.clamp_min(v, 0.0)


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, running_mean: torch.Tensor,
                           running_var: torch.Tensor, eps: float,
                           momentum: float, dtype, act=None,
                           group=None) -> torch.Tensor:
    """Flax's training-mode BatchNorm as eager PyTorch, then ``act``.

    The statistics over N, H, W in f32 from ``x`` rounded to ``dtype``
    (summed over ``group``'s ranks first, when given, by one
    differentiable all-reduce), then ``apply_plain``. Gradients flow
    through the statistics."""
    xf = x.to(dtype).float()
    sums = stats_plain(xf)
    if group is not None:
        sums = all_reduce_sum(sums, group)
    return apply_plain(xf, sums, weight, bias, running_mean, running_var,
                       eps, momentum, dtype, act)


def apply_plain(xf, sums, weight, bias, running_mean, running_var,
                eps: float, momentum: float, dtype, act=None) -> torch.Tensor:
    """The normalize of an f32 map by its ``sums``: the fast variance
    clipped at 0, the running statistics updated in place with it
    (biased), the normalize in f32 rounded once to ``dtype``, ``act``."""
    mean, _, var = channel_stats_plain(sums, eps)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    mul = torch.rsqrt(var + eps) * weight.to(dtype).float()
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return activate((y + bias.to(dtype).float()[:, None, None]).to(dtype), act)


def _coefficients(sums, weight, bias, eps, dtype):
    mean, v, var = channel_stats_plain(sums, eps)
    r = torch.rsqrt(var + eps)
    return mean, v, r, r * weight.to(dtype).float(), bias.to(dtype).float()


def _dz(dy, xf, mean, mul, b, dtype, act):
    """dy through the activation, whose mask comes from the normalized map
    recomputed from ``xf``, in f32."""
    if act is None:
        return dy.float()
    y0 = ((xf - mean[:, None, None]) * mul[:, None, None]
          + b[:, None, None]).to(dtype)
    if act == "relu":
        return torch.where(y0 <= 0, torch.zeros_like(dy), dy).float()
    return torch.where(y0 > 0, dy, dy * LEAKY_SLOPE).float()


def grad_sums_plain(dy, x, sums, weight, bias, eps: float, act=None):
    """[A = Σdz (C), B = Σdz·(x − mean) (C)] of this batch, from the
    forward's ``sums`` and ``x`` in the compute dtype."""
    mean, _, _, mul, b = _coefficients(sums, weight, bias, eps, x.dtype)
    xf = x.float()
    dz = _dz(dy, xf, mean, mul, b, x.dtype, act)
    xc = xf - mean[:, None, None]
    return torch.cat([dz.sum(dim=(0, 2, 3)), (dz * xc).sum(dim=(0, 2, 3))])


def backward_plain(dy, x, sums, gsums, weight, bias, eps: float, act=None,
                   local_gsums=None):
    """(dx, dweight, dbias) of ``batch_norm_train_plain`` from the
    forward's ``sums`` and the gradient sums ``gsums`` (the joined batch's
    under data parallelism; ``local_gsums``, this batch's, give the
    parameter gradients and default to ``gsums``). The parameter gradients
    round to the compute dtype and back, as the cast's backward rounds
    them."""
    dt = x.dtype
    c = x.shape[1]
    mean, v, r, mul, b = _coefficients(sums, weight, bias, eps, dt)
    count = sums[2 * c]
    xf = x.float()
    dz = _dz(dy, xf, mean, mul, b, dt, act)
    a, bm = gsums.split([c, c])
    dvar = (-0.5 * (bm * weight.to(dt).float())) * (r * r * r)
    dv = torch.where(v >= 0, dvar, torch.zeros_like(dvar))
    dmean = -(mul * a) + (-dv * 2.0) * mean
    ds1, c2 = dmean / count, dv / count * 2.0
    dxf = (dz * mul[:, None, None] + ds1[:, None, None]
           + c2[:, None, None] * xf)
    al, bl = (gsums if local_gsums is None else local_gsums).split([c, c])
    return (dxf.to(dt), (bl * r).to(dt).float(), al.to(dt).float())


# ---- the kernels -----------------------------------------------------------------

def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ppn_bn_* {what} launch failed: "
                           f"{lib.ppn_bn_error_string(err).decode()} ({err})")


def _aligned(t: torch.Tensor) -> None:
    if t.data_ptr() % 16 != 0:
        raise ValueError("ppn_bn_* needs maps on a 16-byte boundary")


def _layout(x: torch.Tensor):
    """(x as a channels_last CUDA map, rows, channels, bf16) for the
    kernels, which move 16 bytes a thread; raises on what they do not
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"ppn_bn_* needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ppn_bn_* takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"map {tuple(x.shape)} is not a non-empty "
                         "(N, C, H, W)")
    x = x.contiguous(memory_format=torch.channels_last)
    c = x.shape[1]
    bf16 = x.dtype == torch.bfloat16
    per = 8 if bf16 else 4
    if c % per != 0:
        raise ValueError(f"ppn_bn_* takes channels in multiples of {per} "
                         f"for {x.dtype}, got {c}")
    _aligned(x)
    return x, x.numel() // c, c, bf16


def _workspace(lib, x, rows, c, bf16):
    dev = x.device.index or 0
    key = (rows, c, bf16, dev)
    if key not in _partials:
        p = lib.ppn_bn_partials(rows, c, int(bf16), dev)
        if p < 1:
            raise ValueError(f"ppn_bn_* cannot take {rows} rows of {c} "
                             "channels")
        _partials[key] = p
    return torch.empty(_partials[key] * 2 * c, device=x.device,
                       dtype=torch.float64)


def forward_cuda(x, weight, bias, running_mean, running_var, eps: float,
                 momentum: float, act=None, group=None):
    """(y, sums): the kernels' forward on a CUDA map in its compute dtype,
    the running statistics updated in place; ``sums`` [Σx, Σx², count] are
    the joined batch's under ``group``."""
    global LAUNCHES
    x, rows, c, bf16 = _layout(x)
    for t in (weight, bias, running_mean, running_var):
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError("the scale, bias and running statistics must "
                             f"be contiguous float32 ({c},) on {x.device}")
    lib = _load()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = _workspace(lib, x, rows, c, bf16)
    sums = torch.empty(2 * c + 1, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(s, phases):
        _check(lib, lib.ppn_bn_forward(
            x.data_ptr(), y.data_ptr(), part.data_ptr(), s.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), rows, c, eps, momentum, 1 - momentum,
            int(bf16), ACTS[act], phases, x.device.index or 0, stream),
            "forward")

    if group is None:
        launch(sums, 3)
    else:
        launch(sums, 1)
        sums = all_reduce_sum(sums, group)
        launch(sums, 2)
    LAUNCHES += 3
    return y, sums


def backward_cuda(dy, x, sums, weight, bias, eps: float, act=None,
                  group=None, need_dx: bool = True):
    """(dx or None, dweight, dbias, gsums) by the kernels: ``gsums`` [A,
    B] are the joined batch's under ``group`` (this rank's without dx),
    the parameter gradients this rank's."""
    global LAUNCHES
    x, rows, c, bf16 = _layout(x)
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
    _aligned(dy)
    lib = _load()
    part = _workspace(lib, x, rows, c, bf16)
    grads = torch.empty(4 * c, device=x.device, dtype=torch.float32)
    gsums, dweight, dbias = grads[:2 * c], grads[2 * c:3 * c], grads[3 * c:]
    dx = torch.empty_like(x, memory_format=torch.channels_last) \
        if need_dx else None
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(g, phases):
        _check(lib, lib.ppn_bn_backward(
            dy.data_ptr(), x.data_ptr(), 0 if dx is None else dx.data_ptr(),
            part.data_ptr(), g.data_ptr(), sums.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), rows, c,
            eps, int(bf16), ACTS[act], phases, x.device.index or 0,
            stream), "backward")

    if group is None or not need_dx:
        launch(gsums, 3 if need_dx else 1)
    else:
        launch(gsums, 1)
        gsums = all_reduce_sum(gsums, group)
        launch(gsums, 2)
    LAUNCHES += 3 if need_dx else 2
    return dx, dweight, dbias, gsums


class BatchNormTrain(torch.autograd.Function):
    """The kernels' forward, and their backward as its gradient. Keeps the
    input map (compute dtype) and the per-channel sums for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, act, group):
        y, sums = forward_cuda(x, weight, bias, running_mean, running_var,
                               eps, momentum, act, group)
        ctx.save_for_backward(x, sums, weight, bias)
        ctx.eps, ctx.act, ctx.group = eps, act, group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sums, weight, bias = ctx.saved_tensors
        dx, dweight, dbias, _ = backward_cuda(
            dy, x, sums, weight, bias, ctx.eps, ctx.act, ctx.group,
            need_dx=ctx.needs_input_grad[0])
        return dx, dweight, dbias, None, None, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     eps: float, momentum: float, dtype, act=None,
                     group=None) -> torch.Tensor:
    """Training-mode BatchNorm then ``act``: the kernels for a CUDA tensor,
    the plain version for a CPU one."""
    if x.device.type == "cuda":
        return BatchNormTrain.apply(x.to(dtype), weight, bias, running_mean,
                                    running_var, eps, momentum, act, group)
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, running_mean,
                                      running_var, eps, momentum, dtype, act,
                                      group)
    raise ValueError(f"no training-mode BatchNorm for device {x.device}")
