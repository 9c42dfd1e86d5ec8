"""Iterations a solve of CG on row-sharded vectors, the mean of what
``dist_cg`` returned (``info["iterations"]``)."""


def read(rec):
    return rec["info"].get("iterations")
