"""Seconds of the port's set-up spans of phase ``levels`` (self time): the
solves' dependency levels and the kernel's ticket order. Read from
``sblas_torch.trace``; None where nothing was recorded."""

from portbench.port_trace import phase_s


def read(rec):
    return phase_s("levels")
