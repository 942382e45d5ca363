"""Device ms a training step of the operations launched inside the program's HRNet exchange-unit spans (the forward only: autograd runs their backward after the spans close)."""

from perfbench.yardstick import spans


def read(obs):
    return spans.span_ms(obs, spans.FUSE)
