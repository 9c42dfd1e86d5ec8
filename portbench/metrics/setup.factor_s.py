"""Seconds of the port's set-up spans of phase ``factor`` (self time): the
numeric IC(0)/ILU(0) factorization, every try. Read from
``sblas_torch.trace``; None where nothing was recorded."""

from portbench.port_trace import phase_s


def read(rec):
    return phase_s("factor")
