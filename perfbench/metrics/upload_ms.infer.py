"""Device ms per predict call of host-to-device copies."""

from perfbench.yardstick import readers


def read(obs):
    return readers.upload_ms(obs)
