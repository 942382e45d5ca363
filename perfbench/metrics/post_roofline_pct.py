"""ppn_post_kernel's share of its bandwidth roofline: the bytes the reference's decisions need, per call (%)."""

from perfbench.yardstick import readers


def read(obs):
    return readers.roofline_pct(obs, "ppn_post_kernel", "post_bytes_per_call", per_launch=False)
