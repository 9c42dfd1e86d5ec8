"""The share of the sync-free solve's row cycles spent waiting on flags,
in percent: 100 x wait / (load + wait + fence + gather + store), summed
over the rows of the counting launches (the traced window's, where a
profiler records). None where no counting launch ran."""

from portbench.port_trace import solve_cycles


def read(rec):
    c = solve_cycles()
    if not c or not sum(c.values()):
        return None
    return 100.0 * c["wait"] / sum(c.values())
