"""Seconds of the port's set-up spans of phase ``convert`` (self time): host
format conversions (tril, transposes, COO to CSR) and value casts. Read
from ``sblas_torch.trace``; None where nothing was recorded."""

from portbench.port_trace import phase_s


def read(rec):
    return phase_s("convert")
