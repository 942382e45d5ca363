"""ppn_warp_kernel's share of its bandwidth roofline: the batch read and written once in bf16, per launch (%)."""

from perfbench.yardstick import readers


def read(obs):
    return readers.roofline_pct(obs, "ppn_warp_kernel", "warp_bytes_per_launch", per_launch=True)
