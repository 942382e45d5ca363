"""Device ms per predict call of kernels outside convolutions, copies and the program's two kernels."""

from perfbench.yardstick import readers


def read(obs):
    return readers.nonconv_ms(obs, "calls")
