"""Seconds of the port's set-up spans of phase ``upload`` (self time): host-
to-device copies. Read from ``sblas_torch.trace``; None where nothing was
recorded."""

from portbench.port_trace import phase_s


def read(rec):
    return phase_s("upload")
