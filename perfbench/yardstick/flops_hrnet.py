"""Operations of the PPN model on the HRNet-W32 trunk, counted from the
configuration's published shapes by ``flops.py``'s rules: every
convolution's multiply-adds × 2 on the output grid that TensorFlow's
``SAME`` padding gives (ceil(in / 2) at each stride-2 step). An exchange
unit's 1x1 convs count at their branch's size, before the upsampling.
Padding, BatchNorm, activations, upsampling, the sums, the head's bias
add, the normalize and the post-process are not counted. The count is the
configuration's, not the program's: a rewrite of the program cannot move
it.
"""

from __future__ import annotations

from perfbench.reference.hrnet import conv_specs, conv_strides


def _out(size: int, stride: int) -> int:
    while stride > 1:
        size, stride = -(-size // 2), stride // 2
    return size


def forward_flops(m: dict) -> int:
    """Forward FLOPs of one image."""
    at = conv_strides(m)
    h, w = m["insize"]
    return sum(2 * cin * cout * k * k * _out(h, at[name]) * _out(w, at[name])
               for name, cin, cout, k, _, _ in conv_specs(m))


def train_flops(m: dict) -> int:
    """One training image: the forward and a backward of twice its
    operations (the gradients of the inputs and of the weights)."""
    return 3 * forward_flops(m)
