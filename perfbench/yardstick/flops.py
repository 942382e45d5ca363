"""Operations of the model, counted from the configuration's published
shapes: every convolution's multiply-adds × 2 (He et al. 2016's ResNet trunk
and the PPN head of Sekii, ECCV 2018, at the configured input size), on the
output grid that TensorFlow's ``SAME`` padding gives (ceil(in / stride)).
Padding, BatchNorm, activations, pooling, the head's bias add, the
normalize and the post-process are not counted. The count is the
configuration's, not the program's: a rewrite of the program cannot move it.
"""

from __future__ import annotations

from perfbench.reference.model import _blocks, conv_specs


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_grid(m: dict) -> dict:
    """Output (H, W) of every convolution, by name."""
    h, w = _out(m["insize"][0], 2), _out(m["insize"][1], 2)
    grid = {"backbone.stem": (h, w)}
    h, w = _out(h, 2), _out(w, 2)                       # the 3x3/2 max-pool
    for pre, _, _, s in _blocks(m):
        out = (_out(h, s), _out(w, s))
        for conv in ("conv1", "conv2", "conv3", "proj"):
            # a bottleneck's first 1x1 runs at its block's input size
            first = conv == "conv1" and m["block"] == "bottleneck"
            grid[f"{pre}.{conv}"] = (h, w) if first else out
        h, w = out
    grid["head.block"] = grid["head.out"] = (h, w)
    return grid


def forward_flops(m: dict) -> int:
    """Forward FLOPs of one image."""
    grid = conv_grid(m)
    return sum(2 * cin * cout * k * k * grid[name][0] * grid[name][1]
               for name, cin, cout, k, _, _ in conv_specs(m))


def train_flops(m: dict) -> int:
    """One training image: the forward and a backward of twice its
    operations (the gradients of the inputs and of the weights)."""
    return 3 * forward_flops(m)
