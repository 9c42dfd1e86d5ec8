"""The spmm ranges' least time (``portbench.roofline``) over the device
time of the operations launched inside them, in percent."""

from portbench.roofline import share_pct


def read(rec):
    return share_pct(rec, "spmm")
