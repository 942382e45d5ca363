"""Three forwards' FLOPs of the window's training images as a share of the bf16 peak (%)."""

from perfbench.yardstick import readers


def read(obs):
    return readers.mfu_pct(obs)
