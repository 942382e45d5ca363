"""Kernel launches with a device record inside the window's calls into the program, a training step."""

from perfbench.yardstick import spans


def read(obs):
    return spans.launches_per_step(obs)
