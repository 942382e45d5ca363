"""Device idle share of the traced inference window (%)."""

from perfbench.yardstick import readers


def read(obs):
    return readers.idle_pct(obs)
