"""Host seconds of the port's set-up calls: the host ``CSR`` from the
generated arrays, the plan constructors and the preconditioner's
factorization and solve plans."""


def read(rec):
    return rec["plan_s"]
