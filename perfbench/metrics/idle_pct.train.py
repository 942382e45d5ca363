"""Device idle share of the traced training window (%)."""

from perfbench.yardstick import readers


def read(obs):
    return readers.idle_pct(obs)
