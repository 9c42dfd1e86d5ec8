"""Iterations a solve, the mean of what the solver returned
(``info["iterations"]``)."""


def read(rec):
    return rec["info"].get("iterations")
