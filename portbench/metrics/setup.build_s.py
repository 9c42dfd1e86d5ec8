"""Seconds of the port's set-up spans of phase ``build`` (self time): the plan
and preconditioner constructors and the CSR constructor's checks, less the
spans of the other phases. Read from ``sblas_torch.trace``; None where
nothing was recorded."""

from portbench.port_trace import phase_s


def read(rec):
    return phase_s("build")
