"""The 95th percentile of every solve of the window, each from its start
to its synchronised end (``statistics.quantiles``, inclusive)."""

import statistics


def read(rec):
    times = rec["times"]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94] * 1e3
