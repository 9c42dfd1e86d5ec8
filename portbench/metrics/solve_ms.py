"""The window's wall time over the solves completed in it."""


def read(rec):
    times = rec["times"]
    return rec["window_s"] / len(times) * 1e3 if times else None
