"""The share of rank 0's traced busy device time spent in NCCL's kernels
(the halo's sends and receives and the reductions' all-reduces), in
percent: the operations named ``nccl...`` among the trace's ten costliest
(``device_ops``) over ``busy_s``. None where none is there."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0.0:
        return None
    nccl = sum(s for name, s in tr["device_ops"] if "nccl" in name.lower())
    return 100.0 * nccl / tr["busy_s"] if nccl > 0.0 else None
