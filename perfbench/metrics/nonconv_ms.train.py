"""Device ms per training step of kernels outside convolutions, copies and the program's two kernels."""

from perfbench.yardstick import readers


def read(obs):
    return readers.nonconv_ms(obs, "steps")
