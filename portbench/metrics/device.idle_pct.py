"""The share of the traced window in which no device operation ran."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
