"""Debug checks (counterpart of ``ppn_tpu/utils/debug.py``).

JAX's ``jax_debug_nans`` raises at the first operation that makes a NaN.
The port's counterpart is a forward hook on every module, which raises
``FloatingPointError`` naming the first module (innermost first) whose
output holds a NaN or an infinity, plus ``torch.autograd`` anomaly mode,
which names the forward operation behind a NaN in the backward. Both are
global switches, as the JAX flag is, and each check waits for the device.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.nn.modules.module import register_module_forward_hook
from torch.utils._pytree import tree_leaves
from torch.utils.hooks import RemovableHandle

_hook: Optional[RemovableHandle] = None


def _check_finite(module, inputs, output) -> None:
    for leaf in tree_leaves(output):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise FloatingPointError(
                f"non-finite output (NaN or inf) from {type(module).__name__}"
                f" {module.extra_repr() or ''} of shape {tuple(leaf.shape)}")


def _set_nans(on: bool) -> None:
    global _hook
    if on and _hook is None:
        _hook = register_module_forward_hook(_check_finite)
    elif not on and _hook is not None:
        _hook.remove()
        _hook = None
    torch.autograd.set_detect_anomaly(on)


def enable_checks(nans: bool = True, disable_jit: bool = False) -> None:
    """Turn the NaN checks on for the rest of the process (``nans``).
    ``disable_jit`` exists for the reference's signature: the port runs
    eagerly, so there is no compilation to turn off, and it changes
    nothing."""
    if nans:
        _set_nans(True)


@contextlib.contextmanager
def checking(nans: bool = True):
    """The NaN checks on (or off, ``nans=False``) inside the block; the
    previous state, anomaly mode included, is restored on exit."""
    prev, prev_anomaly = _hook is not None, torch.is_anomaly_enabled()
    _set_nans(nans)
    try:
        yield
    finally:
        _set_nans(prev)
        torch.autograd.set_detect_anomaly(prev_anomaly)
