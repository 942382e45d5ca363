"""Train and eval steps (port of ``ppn_tpu/train/steps.py``).

One ``train_step`` is: on-device augmentation (one ``ppn_warp_kernel``
launch) → target encoding → forward in ``cfg.train.dtype`` with f32
parameters and training-mode BatchNorm → the 5-term loss → backward → SGD
with momentum and masked weight decay → EMA of the parameters.

The optimizer is written out instead of ``torch.optim.SGD`` so that it
follows optax's ``chain(add_decayed_weights(wd, mask), sgd(lr, 0.9))``
term by term: ``g ← g + wd·p`` on parameters with ``ndim > 1`` only,
``trace ← g + 0.9·trace``, ``p ← p + (−lr)·trace``, with ``lr`` the
schedule at the number of steps already taken (0 on the first step under
warmup). ``make_multi_train_step`` runs K such steps per call over
batches gathered from a ``DeviceCache`` by a (K, B) index block.

Data parallel (``mesh`` of more than one rank, ``parallel/mesh.py``): each
rank augments and encodes its slice of the global batch, BatchNorm takes
its statistics over the joined batch (``nn/resnet.global_batch_stats``),
and the gradients are averaged over the data group by one all-reduce of a
flat buffer. The loss averages over the rank's rows, so with equal slices
that mean is the joined batch's gradient, and every rank applies the same
update to the same replicated state.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ppn_tpu_torch import resolve_device
from ppn_tpu_torch.configs import Config
from ppn_tpu_torch.nn.model import DTYPES, PoseProposalNet
from ppn_tpu_torch.nn.resnet import global_batch_stats
from ppn_tpu_torch.ops import encode as enc
from ppn_tpu_torch.ops.augment import augment_batch
from ppn_tpu_torch.ops.tta import flip_tta_forward
from ppn_tpu_torch.train.loss import ppn_loss

BATCH_KEYS = ("image", "keypoints", "visible", "bboxes", "valid")


@dataclasses.dataclass
class TrainState:
    """Model (parameters and BatchNorm statistics), momentum traces, EMA of
    the parameters (None when ``ema_decay`` is 0), the number of steps
    taken and the generator that drives the augmentation."""

    model: PoseProposalNet
    trace: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The parameters eval and inference use: the EMA copy when tracked."""
    if state.ema is not None:
        return state.ema
    return {n: p.detach() for n, p in state.model.named_parameters()}


def eval_model(state: TrainState) -> PoseProposalNet:
    """A copy of the state's model in eval mode holding the eval parameters
    (the EMA when tracked) and the BatchNorm running statistics, for
    inference."""
    model = copy.deepcopy(state.model).eval()
    weights = eval_params(state)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate at a step count, as the JAX package's optax
    schedule computes it, in f32: ``cosine`` is
    ``warmup_cosine_decay_schedule`` with ``decay_steps = max(num_steps,
    warmup + 1)``; ``constant`` and ``step`` join a linear warmup, and
    ``step``'s decays at 60% and 85% of ``num_steps`` are offset by the
    warmup as the join shifts them."""
    t = cfg.train
    f = np.float32
    lr, warm = f(t.learning_rate), t.warmup_steps

    if t.lr_schedule == "constant":
        def sched(count):
            return lr
    elif t.lr_schedule == "cosine":
        decay = max(t.num_steps, warm + 1) - warm

        def sched(count):
            c = f(min(count, decay))
            return lr * (f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay))))
    elif t.lr_schedule == "step":
        bounds = sorted({int(t.num_steps * 0.6) - warm: 0.1,
                         int(t.num_steps * 0.85) - warm: 0.1}.items())

        def sched(count):
            v = lr
            for bound, scale in bounds:
                if count >= bound:
                    v = f(scale) * v
            return v
    else:
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")

    def joined(count):
        # optax.join_schedules([linear_schedule(0, lr, warm), sched],
        # [warm]); with no warmup it is sched itself
        if count < warm:
            return float(-lr * (f(1) - f(max(count, 0)) / f(warm)) + lr)
        return float(sched(count - warm))

    return joined


def _seeded_model(cfg: Config, seed: int) -> PoseProposalNet:
    """A fresh model whose initial weights depend on ``seed`` only."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return PoseProposalNet(cfg.model, dtype=DTYPES[cfg.train.dtype])


def create_train_state(cfg: Config, seed: Optional[int] = None,
                       device=None, pretrained: Optional[str] = None
                       ) -> TrainState:
    """A fresh train state on ``device`` (``cuda`` unless asked otherwise):
    a training-mode model seeded from ``seed`` (default the config's), zero
    traces, the EMA seeded from the parameters when ``ema_decay > 0``, and
    a generator on the device seeded likewise. ``pretrained``: a
    torchvision-format ResNet ``.pth`` whose weights and BatchNorm
    statistics initialize the backbone (``utils/torch_import.py``)."""
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    model = _seeded_model(cfg, seed)
    if pretrained:
        from ppn_tpu_torch.utils.torch_import import load_torch_resnet_file

        used = load_torch_resnet_file(model.backbone, pretrained)
        print(f"initialized backbone from {pretrained} ({used} tensors)")
    model = model.to(dev).train()
    params = dict(model.named_parameters())
    trace = {n: torch.zeros_like(p) for n, p in params.items()}
    ema = ({n: p.detach().clone() for n, p in params.items()}
           if cfg.train.ema_decay > 0 else None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return TrainState(model=model, trace=trace, ema=ema, step=0,
                      generator=gen)


def _to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(dev) for k in BATCH_KEYS}


def loss_and_grads(cfg: Config, state: TrainState, batch,
                   augment: bool = False, mesh=None):
    """Augment (when asked) → encode → forward in training mode (which
    updates the BatchNorm running statistics) → loss → backward. Returns
    (loss terms, gradients by parameter name) of this rank's rows; under a
    ``mesh`` the augmentation draws and the BatchNorm statistics are the
    joined batch's."""
    m = cfg.model
    dev = state.device
    model = state.model.train()
    batch = _to_device(batch, dev)
    group = None if mesh is None else mesh.group()
    if augment:
        shard = (0, 1) if mesh is None else (mesh.rank(), mesh.size())
        batch = augment_batch(m, cfg.data, state.generator, batch,
                              device=dev, shard=shard)
    targets = enc.encode_batch(m, batch["keypoints"], batch["visible"],
                               batch["bboxes"], batch["valid"])
    with global_batch_stats(group):
        return forward_backward(cfg, model, batch["image"], targets)


def forward_backward(cfg: Config, model: PoseProposalNet,
                     images: torch.Tensor, targets
                     ) -> tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """The loss of ``model`` on ``images`` against encoded ``targets``, then
    its backward: (loss terms, gradients by parameter name)."""
    _, terms = ppn_loss(cfg.model, model(images), targets)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(terms["loss_total"], params)
    return ({k: v.detach() for k, v in terms.items()},
            dict(zip(names, grads)))


def grad_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The global norm of the gradients. On a CUDA device, the norm of
    their norms in a few multi-tensor launches (tree reductions); on the
    CPU, whose ``_foreach_norm`` adds in one running f32 sum (rel 8e-5 off
    over 4M values), their squares summed in ``grads``' order."""
    gs = list(grads.values())
    if gs[0].is_cuda:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))


def average_over_data(mesh, tensors: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The mean of each (f32) tensor over the mesh's data group: one
    all-reduce of one flat buffer. Without a process group, the tensors as
    they are."""
    group = None if mesh is None else mesh.group()
    if group is None:
        return tensors
    names = list(tensors)
    flat = torch.cat([tensors[n].reshape(-1) for n in names])
    torch.distributed.all_reduce(flat, group=group)
    flat /= mesh.size()
    parts = flat.split([tensors[n].numel() for n in names])
    # each back in its tensor's memory layout (cuDNN's weight gradients are
    # channels_last): grad_norm sums in memory order, so a contiguous copy
    # would part from one process's grad_norm in the last bits
    return {n: torch.empty_like(tensors[n]).copy_(p.view_as(tensors[n]))
            for n, p in zip(names, parts)}


@torch.no_grad()
def sgd_update(cfg: Config, state: TrainState,
               grads: Dict[str, torch.Tensor]) -> None:
    """One optimizer step on ``state`` in place: masked weight decay,
    momentum, the scheduled learning rate, then the EMA of the parameters
    ``e·d + p·(1 − d)``; the step count advances."""
    t = cfg.train
    names, params = zip(*state.model.named_parameters())
    decayed = [grads[n] for n in names]
    wide = [i for i, p in enumerate(params) if p.ndim > 1]
    decay = torch._foreach_mul([params[i] for i in wide], t.weight_decay)
    torch._foreach_add_(decay, [decayed[i] for i in wide])   # g + wd·p
    for i, d in zip(wide, decay):
        decayed[i] = d
    traces = [state.trace[n] for n in names]
    torch._foreach_mul_(traces, t.momentum)
    torch._foreach_add_(traces, decayed)          # g + μ·trace
    lr = make_lr_schedule(cfg)(state.step)
    torch._foreach_add_(list(params), torch._foreach_mul(traces, -lr))
    if state.ema is not None:
        d = t.ema_decay
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(list(params), 1.0 - d))
    state.step += 1


def train_step(cfg: Config, state: TrainState, batch,
               augment: bool = False, mesh=None) -> Dict[str, torch.Tensor]:
    """One SGD step on ``state`` in place. ``batch`` holds image (B, H, W, 3)
    uint8 or f32 in [0, 1], keypoints (B, P, K, 2), visible (B, P, K),
    bboxes (B, P, 4) and valid (B, P), as arrays or tensors — under a
    ``mesh``, this rank's slice of the global batch. Returns the loss terms
    and ``grad_norm`` (the global norm of the gradients) of the global
    batch as 0-d tensors on the device; reading them waits for the step."""
    terms, grads = loss_and_grads(cfg, state, batch, augment, mesh)
    both = average_over_data(mesh, {**grads, **terms})
    grads = {n: both[n] for n in grads}
    terms = {k: both[k] for k in terms}
    terms["grad_norm"] = grad_norm(grads)
    sgd_update(cfg, state, grads)
    return terms


def make_multi_train_step(cfg: Config, augment: bool = True,
                          steps_per_call: int = 8, mesh=None):
    """K = ``steps_per_call`` SGD steps per call over a device-resident
    dataset (the JAX package's ``lax.scan`` loop, written eagerly).

    Returns ``multi_step(state, cache, idx) -> mean_terms``: ``cache`` is a
    ``data/device_cache.DeviceCache`` (under ``mesh``, sharded or not: its
    ``batch`` gives this rank's slice), ``idx`` a (K, B) block of global
    sample indices; the state advances K steps in place and the loss terms,
    ``grad_norm`` included, come back averaged over the K steps. Each step
    is one ``train_step`` on ``cache.batch(idx[k])``, the same kernels in
    the same order, so K steps here are bitwise K ``train_step`` calls on
    the same batches."""
    k = int(steps_per_call)
    if k < 1:
        raise ValueError(f"steps_per_call {steps_per_call} must be >= 1")

    def multi_step(state: TrainState, cache, idx) -> Dict[str, torch.Tensor]:
        idx = np.asarray(idx)
        if idx.ndim != 2 or len(idx) != k:
            raise ValueError(f"an index block of shape {idx.shape}; "
                             f"expected ({k}, batch)")
        terms = [train_step(cfg, state, cache.batch(i), augment, mesh)
                 for i in idx]
        return {name: torch.stack([t[name] for t in terms]).mean(0)
                for name in terms[0]}

    return multi_step


def eval_loss_step(cfg: Config, state: TrainState,
                   batch) -> Dict[str, torch.Tensor]:
    """Loss terms with running-average BatchNorm and no state change."""
    batch = _to_device(batch, state.device)
    targets = enc.encode_batch(cfg.model, batch["keypoints"],
                               batch["visible"], batch["bboxes"],
                               batch["valid"])
    was_training = state.model.training
    state.model.eval()
    try:
        with torch.no_grad():
            _, terms = ppn_loss(cfg.model, state.model(batch["image"]),
                                targets)
    finally:
        state.model.train(was_training)
    return terms


def make_forward(state: TrainState, flip_tta: bool = False
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inference forward: images → f32 feature map, with eval-mode
    BatchNorm (running statistics) and the eval (EMA when tracked)
    parameters. ``flip_tta`` also runs the mirrored images and merges the
    two maps in logit space, in f32 (``ops/tta.py``): one extra forward,
    no extra post-process pass."""
    m = state.model.cfg

    def forward(images: torch.Tensor) -> torch.Tensor:
        model = state.model
        was_training = model.training
        model.eval()
        weights = {**dict(model.named_buffers()), **eval_params(state)}

        def call(x):
            return torch.func.functional_call(model, weights, (x,))

        try:
            with torch.no_grad():
                if flip_tta:
                    return flip_tta_forward(m, call, images)
                return call(images)
        finally:
            model.train(was_training)

    return forward
