"""Faults planted in the program's timed path, to show that a cell's check
catches them: the tests plant them at tiny_test on the CPU, and
``calibrate.py --fault`` at a cell's own size on the card. The
benchmark's runs never plant one.

- ``unchanged``: the optimizer step returns the state unchanged (but for
  its step count);
- ``later_unchanged``: as ``unchanged``, from the second K-step call on
  (the first is sound): a fault that shows only after the first call, as
  a replayed graph that does nothing would;
- ``half_batch``: the loss and its gradients are taken over the first half
  of each batch only, the mean over the rest;
- ``half_images``: inference leaves the second half of each batch out
  (zeros go through the model in its place);
- ``altered``: the post-process's persons are altered where they are
  produced (one more person, with three keypoints, in the first image).
"""

from __future__ import annotations

import contextlib

import torch


def _unchanged():
    from ppn_tpu_torch.train import steps

    def unchanged(cfg, state, grads):
        state.step += 1

    return steps, "sgd_update", unchanged


def _later_unchanged():
    from ppn_tpu_torch.train import steps

    real = steps.make_multi_train_step

    def make(*args, **kwargs):
        call, calls = real(*args, **kwargs), []

        def later(state, cache, idx):
            calls.append(1)
            if len(calls) == 1:
                return call(state, cache, idx)
            with planted("unchanged"):
                return call(state, cache, idx)

        return later

    return steps, "make_multi_train_step", make


def _half_batch():
    from ppn_tpu_torch.train import steps

    real = steps.forward_backward

    def half(cfg, model, images, targets):
        h = len(images) // 2
        return real(cfg, model, images[:h],
                    type(targets)(*(t[:h] for t in targets)))

    return steps, "forward_backward", half


def _half_images():
    from ppn_tpu_torch.ops import postprocess

    real = postprocess.forward_postprocess_fast

    def half(cfg, model, images, device=None):
        images = torch.as_tensor(images).clone()
        images[len(images) // 2:] = 0
        return real(cfg, model, images, device)

    return postprocess, "forward_postprocess_fast", half


def _altered():
    from ppn_tpu_torch.ops import postprocess

    real = postprocess.postprocess_batch_fast

    def altered(cfg, fm):
        ppl = real(cfg, fm)
        ppl.valid[0, -1] = True
        ppl.kp_valid[0, -1, :3] = True
        ppl.kp_cell[0, -1, :3] = torch.tensor([[0, 0], [0, 1], [1, 0]],
                                              dtype=ppl.kp_cell.dtype)
        return ppl

    return postprocess, "postprocess_batch_fast", altered


FAULTS = {"unchanged": _unchanged, "later_unchanged": _later_unchanged,
          "half_batch": _half_batch,
          "half_images": _half_images, "altered": _altered}


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` planted inside the block."""
    module, attr, broken = FAULTS[name]()
    real = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, real)
