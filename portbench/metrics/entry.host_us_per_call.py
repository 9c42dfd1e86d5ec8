"""Host microseconds of a call into a plan or preconditioner of the port,
the mean over the traced window's ranges around such calls."""


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    spans = [s for v in tr["host_s"].values() for s in v]
    return sum(spans) / len(spans) * 1e6 if spans else None
