"""The arithmetic of the per-layer metrics, over a run's observations
(``obs``): the traced window (``trace``, a ``yardstick.trace.Trace``), the
counts of the window's work (``calls``, ``steps``, ``images``), the card's
name (``card``) and the operations and bytes the yardstick computed. Each
returns None where the run gives it nothing to read: no traced window, a
window whose launches were not all recorded, a card without a data-sheet
peak, or no launch of the kernel read. None is never written as 0."""

from __future__ import annotations

from typing import Optional

from perfbench.yardstick.peaks import peak
from perfbench.yardstick.trace import POST_KERNEL, WARP_KERNEL, category

NOT_NONCONV = ("conv", "copy", POST_KERNEL, WARP_KERNEL)


def _trace(obs: dict):
    tr = obs.get("trace")
    return tr if tr is not None and tr.whole else None


def idle_pct(obs: dict) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    tr = _trace(obs)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(obs: dict) -> Optional[float]:
    """The configuration's FLOPs of the traced window's images over its
    length, as a share of the card's dense bf16 peak."""
    tr, top = _trace(obs), peak(obs.get("card", ""), "bf16_flops")
    if tr is None or top is None or not obs.get("images"):
        return None
    return 100.0 * obs["flops_per_image"] * obs["images"] / tr.window_s / top


def nonconv_ms(obs: dict, per: str) -> Optional[float]:
    """Device ms per ``per`` (calls or steps) of kernels that are not
    convolutions or GEMMs, copies, or the program's two own kernels."""
    tr = _trace(obs)
    if tr is None or not obs.get(per):
        return None
    return 1e3 * tr.seconds(lambda n: category(n) not in NOT_NONCONV) \
        / obs[per]


def upload_ms(obs: dict) -> Optional[float]:
    """Device ms per call of host-to-device copies."""
    tr = _trace(obs)
    if tr is None or not obs.get("calls"):
        return None
    return 1e3 * tr.seconds(lambda n: "HtoD" in n) / obs["calls"]


def roofline_pct(obs: dict, kernel: str, bytes_key: str,
                 per_launch: bool) -> Optional[float]:
    """The least time the card's bandwidth allows for the kernel's bytes,
    over the kernel's measured time (per launch, or per call)."""
    tr, bw = _trace(obs), peak(obs.get("card", ""), "hbm_bytes")
    if tr is None or bw is None or obs.get(bytes_key) is None:
        return None
    mine = lambda n: kernel in n  # noqa: E731
    launches = tr.count(mine)
    if not launches:
        return None
    per = launches if per_launch else obs["calls"]
    return 100.0 * (obs[bytes_key] / bw) / (tr.seconds(mine) / per)

