"""Process start to the first timed solve: generation, the port's set-up,
the kernels' build or load, and the warm-up solve."""


def read(rec):
    return rec["setup_s"]
