"""PageRank on the scattered-graph path: the counterpart of
``examples/pagerank.py`` (power-law adjacency, repeated SpMV).

Usage pattern demonstrated:

- build the column-stochastic operator M = A^T D^-1 on the host with the
  format toolkit (csr_transpose and a scale of the values);
- one SpmvPlan, whose hub relabeling (``method="pseg"``) is paid once;
- with ``pseg`` the power iteration calls the kernel in the relabeled
  space through ``SpmvPlan.apply_permuted``: the plan permutes nothing
  around it.

Run:  python -m sblas_torch.examples.pagerank [n_nodes] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import datasets
from ..formats import CSR, csr_transpose
from ..ops.spmv import SpmvPlan
from ..utils.backend import pick_device


def stochastic_transpose(a):
    """M = A^T D^-1 (column-stochastic), D = out-degree; dangling nodes
    get a zero column (handled by the damping term)."""
    deg = np.maximum(a.row_lengths.astype(np.float64), 1.0)
    # PageRank uses the unit adjacency (dataset generators carry random
    # benchmark values): edge weight = 1/out-degree
    w = (1.0 / np.repeat(deg, a.row_lengths)).astype(a.dtype)
    return csr_transpose(CSR(a.shape, a.indptr, a.indices, w))


def pagerank(a, *, damping=0.85, tol=1e-8, maxiter=200, method="auto",
             device=None, **plan_kw):
    """Returns (rank vector in f64 on the plan's device, iterations). A
    loop around a single plan; the rank vector is kept in f64 and the
    products are taken in the matrix's dtype."""
    n = a.shape[0]
    m_op = stochastic_transpose(a)
    plan = SpmvPlan(m_op, method, device=device, **plan_kw)
    dev = plan.device
    dangling = torch.as_tensor((a.row_lengths == 0).astype(np.float64),
                               device=dev)
    permuted = plan.method == "pseg"
    if permuted:
        # x_perm = x[colperm] in; row i of the result is row rowperm[i]
        colperm = torch.as_tensor(plan.colperm, device=dev).long()
        rowperm = torch.as_tensor(plan.rowperm, device=dev).long()

    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for it in range(1, maxiter + 1):
        if permuted:
            mr = torch.zeros(n, dtype=torch.float64, device=dev)
            mr[rowperm] = plan.apply_permuted(
                r[colperm].to(plan.dtype)).double()
        else:
            mr = plan(r.to(plan.dtype)).double()
        leak = damping * (dangling @ r) / n            # dangling mass
        r_new = (1.0 - damping) / n + damping * mr + leak
        delta = float((r_new - r).abs().sum())         # the one host read
        r = r_new
        if delta < tol:
            return r, it
    return r, maxiter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=30000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    g = datasets.powerlaw_graph(args.n, 12.0, 2.1, seed=0, dtype=np.float32)
    r, it = pagerank(g, method="auto", device=dev)
    r = r.cpu().numpy()
    top = np.argsort(-r)[:5]
    print(f"converged in {it} iterations; sum(r) = {r.sum():.6f}")
    print("top nodes:", top.tolist(), [round(float(r[t]), 6) for t in top])

    # the relabeled-space pseg path against the plain bucket route on a
    # web-graph emulation
    gs = datasets.emulate("uk-2002", scale=0.01, dtype=np.float32)
    r1, _ = pagerank(gs, method="pseg", device=dev)
    r2, _ = pagerank(gs, method="bucket", device=dev)
    print("pseg-vs-bucket max diff:", float((r1 - r2).abs().max()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
