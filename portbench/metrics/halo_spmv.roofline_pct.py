"""The halo_spmv ranges' least time (the rank's local SpMV on its
``(rows, rows + 2H)`` block, ``portbench.roofline``) over the device time
of the operations launched inside them, the halo exchange included, in
percent: rank 0's."""

from portbench.roofline import share_pct


def read(rec):
    return share_pct(rec, "halo_spmv")
